"""Map3DGenerator: pose-mapping field + volume render + 2D synthesis
(threedhumangan_tpu/models/generator.py).

``generator_forward`` / ``staged_forward`` (eval) run: the mapping
networks, weak-perspective rays, the geo features
(``models.smpl.get_geo_features``), the field render, a bilinear resize of
the feature map, and K3 synthesis (``ops.synthesis_kernel.fused_synthesis``),
under no-grad.

The JAX meta flags that pick the field path's kernels select the port's
counterparts, with the JAX package's on-accelerator values as defaults
(``bench.py:70-80``):

  pallas_geo (True)         K1 geo features; False: torch around a 1-NN
  pallas_knn (True)         with pallas_geo False: the 1-NN on K6, else the
                            plain expanded-form search (``ops.knn.knn_points``)
  pallas_fold_film (True)   K2 folded field render; False: K4 unfolded
  pallas_march_loop (False) True: K4 (the JAX loop-mode kernel)
  pallas_fuse_geo (False)   True: K5, the geo features inside the field
                            render (no K1, K2 or K6), off the grad path and
                            without ``disable_modulation``

(``ops.raymarch.fused_field_render`` also takes K4 for a field with fewer
than 2 trunk blocks.)  The TPU-only knobs ``pallas_tile_rays``,
``pallas_step_pack``, ``pallas_fold_pipe2``, ``pallas_geo_tile_points``,
``pallas_geo_tile_rays`` and ``pallas_interpret`` size or schedule Pallas
kernels and have no role here.  Nor does ``pallas_synthesis``: the JAX flag
picks its fused synthesis kernel against the per-op eval stack
(JAX ``generator.py:498-504``), two ways to compute the same function, and
the port always runs K3 (its plain version on the CPU); False gives the
same output.  The field always renders through the
kernels' path: ``pallas_field``, ``pallas_field_train`` or
``pallas_field_bwd`` set to False (the XLA field and its remat backward)
raise ``NotImplementedError``.

``generator_forward(train=True)`` is the training forward: the nerf noise
(``noise_std * randn`` from the generator) rides as the field render's
noise column, the synthesis runs in train mode (batch moments; BN running
stats and spectral-norm ``u`` updated in place), per op or, with
``meta['pallas_synthesis_train']``, on the fused half-blocks (K10 forward,
K11 backward), and it returns (outputs, the synthesis state).
``pallas_ok=True`` (the D step's fakes, under no-grad) renders with the
selected kernel alone; ``pallas_ok=False`` (the G step) renders through
``ops.raymarch_bwd.FieldRender``, K2 or K4 forward with the K8/K9 backward.

On a CUDA device every kernel launches; on the CPU each wrapper runs its
plain PyTorch version.  Not ported: hierarchical sampling,
``disable_render`` (the condition-image style head), the config-level
``disable_synthesis`` (the train forward's argument of that name is
ported: render-modal phases), 2D label/latent inputs, and nerf noise at
eval; each raises ``NotImplementedError``.  ``remat_synthesis`` (default True, as in the JAX
package) recomputes each synthesis block in the training backward
(``models.synthesis`` docstring); it changes memory and time, not values.
``auto_remat_synthesis`` is the trainers' shape-aware default for it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.models import volume_rendering as vr
from threedhumangan_tpu_torch.models.mapping import MappingNetwork, TwoPartMappingNetwork
from threedhumangan_tpu_torch.models.siren import NEURAL_FIELD_REGISTRY
from threedhumangan_tpu_torch.models.smpl import get_geo_features
from threedhumangan_tpu_torch.ops.geo import build_vertex_features
from threedhumangan_tpu_torch.ops.raymarch import (fused_field_render, fused_field_render_geo,
                                                  pack_field_inputs)
from threedhumangan_tpu_torch.ops.raymarch_bwd import field_render_trainable
from threedhumangan_tpu_torch.ops.synthesis_kernel import fold_synthesis_params, fused_synthesis
from threedhumangan_tpu_torch.utils.misc import resolve_device


# The flip point of ``auto_remat_synthesis``, in bytes of the estimated
# no-remat synthesis residuals, fitted to the MAP3DBN512L batch-32 pair on an
# NVIDIA H100 80GB HBM3 at 700 W (``apps/memory_sweep.py``; 79.18 GiB on the
# card): without remat, micro-batch 8 (estimate 14.77 GiB) peaked at 62.68
# GiB, more than 8 GiB under the card and faster than with remat; micro-batch
# 16 (29.53 GiB) ran out of memory, and with remat peaked at 42.43 GiB.  The
# budget is the smallest round value above the measured fit.
REMAT_RESIDUAL_BUDGET = 16 * 2**30


def synthesis_residual_bytes(meta: Dict, micro_batch: int) -> int:
    """The JAX package's estimate of the synthesis activations a training
    backward keeps without remat: two bf16 maps a block (each half-block's
    input), 2 * blocks * micro-batch * gen_h * gen_w * hidden * 2 bytes."""
    blocks = meta.get("synthesis_blocks", 9)
    return (2 * blocks * micro_batch * meta["gen_height"] * meta["gen_width"]
            * meta["hidden_dim"] * 2)


def auto_remat_synthesis(meta: Dict, micro_batch: int) -> bool:
    """Shape-aware default for ``remat_synthesis`` (JAX
    ``models/generator.py::auto_remat_synthesis``): remat where the
    estimated residuals of one device micro-batch (batch // batch_split)
    exceed ``REMAT_RESIDUAL_BUDGET``."""
    return synthesis_residual_bytes(meta, micro_batch) > REMAT_RESIDUAL_BUDGET


class LatentPool(nn.Module):
    def __init__(self, n: int, latent_dim: int):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(n, latent_dim))


class Map3DGenerator(nn.Module):
    """All generator parameters, in the reference torch key space."""

    def __init__(self, meta: Dict, generator: Optional[torch.Generator] = None):
        super().__init__()
        latent_dim, hidden_dim = meta["latent_dim"], meta["hidden_dim"]
        feature_dim = meta["feature_dim"]
        self.neural_field = NEURAL_FIELD_REGISTRY[meta["neural_field_cls"]](
            input_dim=meta["input_dim"], hidden_dim=hidden_dim,
            geo_feature_dim=meta["geo_feature_dim"], feature_dim=feature_dim,
            num_blocks=meta["neural_field_blocks"])
        syn_in_dim = 2 + (meta["semantic_dim"] if meta.get("2d_semantic_input", False) else 0)
        syn_in_dim += 1 if meta.get("2d_label_input", False) else 0
        self.synthesis_input = syn.SynthesisInput(syn_in_dim, feature_dim)
        style_in_dim = 1 if "segments" in meta["condition_modal_gen"] else 3
        self.synthesis_style_input = syn.SynthesisStyleInput(
            style_in_dim, latent_dim, feature_dim, num_layers=3)
        net_in_dim = feature_dim + (latent_dim if meta.get("2d_latent_input", False) else 0)
        self.synthesis_network = syn.SynthesisNetwork(
            net_in_dim, feature_dim, hidden_dim, meta["synthesis_blocks"], meta["mod_blocks"],
            meta.get("spatial_normalization", "instance_norm"),
            meta.get("map3d_mode", "isolated"))
        self.neural_field_mapping_network = MappingNetwork(
            latent_dim, hidden_dim, 2 * meta["neural_field_blocks"] * hidden_dim)
        self.synthesis_mapping_network = TwoPartMappingNetwork(
            latent_dim, feature_dim, implicit_dim=1, num_ws=1, trunk_layers=7,
            branch_layers=1, lr_multiplier=0.01)
        self.latent_pool = LatentPool(meta["dataset_length"], latent_dim)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        for m in (self.neural_field, self.synthesis_input, self.synthesis_style_input,
                  self.synthesis_network, self.neural_field_mapping_network,
                  self.synthesis_mapping_network):
            m.reset_parameters(generator)


def init_generator(meta: Dict, generator: torch.Generator, device="cuda") -> Map3DGenerator:
    """Random generator weights drawn from ``generator`` (JAX init_generator's
    distributions), in eval mode on ``device``."""
    return Map3DGenerator(meta, generator).to(resolve_device(device)).eval()


def _no_stage(name: str):
    return contextlib.nullcontext()


def resize_feature_maps(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres and no antialiasing
    (``jax.image.resize(..., 'bilinear')`` when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def render(gen: Map3DGenerator, freq, phase, conditions: Dict, meta: Dict,
           generator: Optional[torch.Generator] = None, compute_dtype=torch.float32,
           stage: Callable = _no_stage, train: bool = False, nerf_noise=None,
           grad_field: bool = False):
    """Volume-render the pose-conditioned field.  Returns (rgb_render NHWC,
    feature_maps NHWC, depths (B, rays, 1)).  ``train`` draws the nerf
    noise (``nerf_noise``, else meta's); ``grad_field`` renders through
    ``FieldRender`` so that gradients reach the field and freq/phase."""
    if meta.get("hierarchical_sample", False) or meta["clamp_mode"] != "relu":
        raise NotImplementedError("hierarchical sampling / softplus clamp")
    for key in ("pallas_field", "pallas_field_train", "pallas_field_bwd"):
        if not meta.get(key, True):
            raise NotImplementedError(f"{key}=False: the XLA field path is not ported")
    noise_std = meta.get("nerf_noise", 0.5) if nerf_noise is None else nerf_noise
    if noise_std != 0 and not train:
        raise NotImplementedError("nerf noise belongs to training; set meta['nerf_noise'] = 0")
    # the geo features inside the field render: off the grad path and
    # without disable_modulation (JAX generator.py:215-220)
    fuse_geo = (meta.get("pallas_fuse_geo", False) and not grad_field
                and not meta.get("disable_modulation", False))
    render_w, render_h, S = meta["render_width"], meta["render_height"], meta["num_steps"]
    B = freq.shape[0]
    with stage("rays"):
        focals = conditions["intrinsics"][:, 0, 0]
        scales = conditions["scales"].float()
        points_cam, z_vals, rays_d_cam = vr.get_initial_rays_weak_perspective(
            focals, scales, S, (render_w, render_h), meta["ray_start"], meta["ray_end"])
        points, z_vals, ray_dirs = vr.transform_sampled_points(
            points_cam, z_vals, rays_d_cam, conditions["cam2world_matrices"], generator,
            perturb=meta.get("perturb_rays", True))
        points = points.reshape(B, render_w * render_h * S, 3)
        dirs = vr.expand_ray_directions(ray_dirs, S)
        if meta.get("lock_view_dependence", False):
            dirs = torch.zeros_like(dirs)
            dirs[..., -1] = -1.0
    f32 = lambda t: t.float().contiguous()
    with stage("geo"):
        if fuse_geo:  # only the per-vertex [inverse-FK 16; T-pose 3] table
            vfeat = build_vertex_features(conditions["tpose_vertices"], conditions["fk_matrices"],
                                          conditions["lbs_weights"])
        elif meta.get("disable_modulation", False):
            geo = points.new_zeros(B, points.shape[1], meta["geo_feature_dim"])
        else:
            geo = get_geo_features(
                points, f32(conditions["skeletons_xyz"]), f32(conditions["vertices"]),
                f32(conditions["tpose_vertices"]), f32(conditions["fk_matrices"]),
                f32(conditions["lbs_weights"]), legacy_mode=meta.get("legacy_mode", False),
                use_pallas_knn=meta.get("pallas_knn", True),
                use_pallas_geo=meta.get("pallas_geo", True), ray_layout=(render_w, S))
    with stage("field"):
        noise = None
        if noise_std != 0:
            noise = noise_std * torch.randn(B, points.shape[1], 1, generator=generator,
                                            device=points.device)
        z_flat = z_vals.reshape(B, render_w * render_h, S)
        kw = dict(white_back=meta.get("white_back", False), last_back=meta.get("last_back", False),
                  compute_dtype=compute_dtype, exact_sin=not meta.get("fast_math", True))
        if fuse_geo:
            packed = torch.cat([points, dirs] + ([noise] if noise is not None else []), -1)
            render_out, depths = fused_field_render_geo(
                gen.neural_field, packed, freq, phase, z_flat, f32(conditions["vertices"]),
                vfeat, f32(conditions["skeletons_xyz"]), S, 2.0 / meta["side_length"],
                legacy_mode=meta.get("legacy_mode", False), **kw)
        else:
            packed = pack_field_inputs(points, geo, dirs, 2.0 / meta["side_length"], noise=noise)
            render_fn = field_render_trainable if grad_field else fused_field_render
            # the JAX loop-mode kernel is the unfolded one: both select K4
            fold = meta.get("pallas_fold_film", True) and not meta.get("pallas_march_loop", False)
            render_out, depths = render_fn(gen.neural_field, packed, freq, phase, z_flat, S,
                                           fold_film=fold, **kw)
    render_out = render_out.reshape(B, render_h, render_w, -1)
    return render_out[..., :3] * 2.0 - 1.0, render_out[..., 3:], depths


@torch.no_grad()
def generate_avg_latent(gen: Map3DGenerator, meta: Dict, generator: torch.Generator,
                        n: int = 10000, device="cuda"):
    """Mean (z, freq, phase, style) over n latents."""
    z = torch.randn(n, meta["latent_dim"], generator=generator, device=resolve_device(device))
    freq, phase = gen.neural_field_mapping_network(z)
    _, styles = gen.synthesis_mapping_network(z)
    return tuple(t.mean(0, keepdim=True) for t in (z, freq, phase, styles))


def generator_forward(gen: Map3DGenerator, z, conditions: Dict, meta: Dict,
                      generator: Optional[torch.Generator] = None,
                      compute_dtype=torch.float32, truncation_psi: float = 1.0,
                      avg_latent=None, with_depth: bool = False,
                      stage: Callable = _no_stage, train: bool = False, nerf_noise=None,
                      latent_indices=None, pallas_ok: bool = True,
                      disable_synthesis: bool = False):
    """Eval forward (``train=False``): returns {'rgbs', 'rgbs_render'} NHWC
    in [-1, 1], plus 'depths' and 'skeletons' when ``with_depth``.  Train
    forward: returns ({'rgbs', 'rgbs_render'}, synthesis state), see the
    module docstring; ``disable_synthesis`` (train only, a render-modal
    phase) skips the mapping to styles, the resize and the synthesis and
    returns the render as both images, with the synthesis state untouched.
    ``stage(name)`` returns a context manager wrapped around each stage
    (for timing)."""
    if train:
        return _train_forward(gen, z, conditions, meta, generator, compute_dtype, nerf_noise,
                              latent_indices, pallas_ok, stage, disable_synthesis)
    if disable_synthesis:
        raise NotImplementedError("disable_synthesis at eval")
    return _eval_forward(gen, z, conditions, meta, generator, compute_dtype, truncation_psi,
                         avg_latent, with_depth, stage)


def _check_synthesis(meta: Dict):
    norm = meta.get("spatial_normalization")
    if (meta.get("disable_synthesis", False) or meta.get("2d_label_input", False)
            or meta.get("2d_latent_input", False)
            or norm not in ("batch_norm", "adaptive_batch_norm")):
        raise NotImplementedError("synthesis needs batch-norm SPADE without 2D label/latent inputs")
    if meta.get("disable_render", False):
        raise NotImplementedError("disable_render (the condition-image style head)")
    if meta.get("feature_map_interpolation", "bilinear") != "bilinear":
        raise NotImplementedError("only bilinear feature-map interpolation is ported")
    return norm


def _train_forward(gen, z, conditions, meta, generator, compute_dtype, nerf_noise,
                   latent_indices, pallas_ok, stage, disable_synthesis):
    _check_synthesis(meta)
    B = z.shape[0]
    latent = z if latent_indices is None else gen.latent_pool.latents[latent_indices.long()]
    with stage("mapping"):
        field_latent = (latent if meta.get("neural_field_latent_input", True)
                        else torch.zeros_like(latent))
        freq, phase = gen.neural_field_mapping_network(field_latent, compute_dtype)
        if not disable_synthesis:
            _, styles = gen.synthesis_mapping_network(latent, compute_dtype)
    rgb_render, feature_maps, _ = render(gen, freq, phase, conditions, meta, generator,
                                         compute_dtype, stage, train=True, nerf_noise=nerf_noise,
                                         grad_field=not pallas_ok)
    if disable_synthesis:  # the render is the output; the feature channels get no cotangent
        return ({"rgbs": rgb_render, "rgbs_render": rgb_render},
                dict(gen.synthesis_network.named_buffers()))
    gen_h, gen_w = meta["gen_height"], meta["gen_width"]
    with stage("resize"):
        feature_maps = resize_feature_maps(feature_maps.to(compute_dtype), gen_h, gen_w)
    with stage("synthesis"):
        coords = syn.get_2d_coords(B, gen_h, gen_w, device=z.device)
        x = gen.synthesis_input(coords, compute_dtype)
        # pallas_synthesis_train (the JAX key) picks the fused half-blocks,
        # K10 forward / K11 backward; the JAX TPU-only keys
        # pallas_synthesis_train_tile_rows and pallas_interpret have no role here
        rgbs = gen.synthesis_network(x, feature_maps, styles, compute_dtype, train=True,
                                     fused=meta.get("pallas_synthesis_train", False),
                                     remat=meta.get("remat_synthesis", True))
    return ({"rgbs": rgbs, "rgbs_render": rgb_render},
            dict(gen.synthesis_network.named_buffers()))


@torch.no_grad()
def _eval_forward(gen, z, conditions, meta, generator, compute_dtype, truncation_psi,
                  avg_latent, with_depth, stage):
    B = z.shape[0]
    gen_h, gen_w = meta["gen_height"], meta["gen_width"]
    render_h, render_w = meta["render_height"], meta["render_width"]
    norm = _check_synthesis(meta)
    latent = z
    with stage("mapping"):
        field_latent = (latent if meta.get("neural_field_latent_input", True)
                        else torch.zeros_like(latent))
        freq, phase = gen.neural_field_mapping_network(field_latent, compute_dtype)
        _, styles = gen.synthesis_mapping_network(latent, compute_dtype)
        if truncation_psi < 1.0:
            if avg_latent is None:
                avg_latent = generate_avg_latent(gen, meta, generator, device=z.device)
            avg_z, avg_freq, avg_phase, avg_styles = avg_latent
            freq = avg_freq + truncation_psi * (freq - avg_freq)
            phase = avg_phase + truncation_psi * (phase - avg_phase)
            styles = avg_styles + truncation_psi * (styles - avg_styles)

    rgb_render, feature_maps, depths = render(
        gen, freq, phase, conditions, meta, generator, compute_dtype, stage)

    with stage("resize"):
        feature_maps = resize_feature_maps(feature_maps.to(compute_dtype), gen_h, gen_w)

    with stage("synthesis"):
        folded = fold_synthesis_params(gen.synthesis_network, gen.synthesis_input, norm)
        rgbs = fused_synthesis(folded, feature_maps, styles, meta["synthesis_blocks"],
                               tuple(meta["mod_blocks"]), meta.get("map3d_mode", "isolated"),
                               compute_dtype)
    output = {"rgbs": rgbs, "rgbs_render": rgb_render}

    if with_depth:
        focals = conditions["intrinsics"][:, 0, 0]
        z_centers = focals / conditions["scales"].float()
        depth = (depths - z_centers.reshape(B, 1, 1)) / (meta["depth_length"] / 2.0)
        output["depths"] = torch.clamp(depth, -1.0, 1.0).reshape(B, render_h, render_w, 1)
        output["skeletons"] = conditions["skeletons_xyz"]
    return output


def staged_forward(gen: Map3DGenerator, z, conditions: Dict, meta: Dict,
                   generator: Optional[torch.Generator] = None,
                   truncation_psi: Optional[float] = None, avg_latent=None,
                   compute_dtype=torch.float32, stage: Callable = _no_stage) -> Dict:
    """Inference entry: truncation from ``meta['truncation_psi']`` and depth."""
    psi = meta.get("truncation_psi", 1.0) if truncation_psi is None else truncation_psi
    return generator_forward(gen, z, conditions, meta, generator, compute_dtype=compute_dtype,
                             truncation_psi=psi, avg_latent=avg_latent, with_depth=True,
                             stage=stage)
