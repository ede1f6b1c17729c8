"""Map3DGenerator: pose-mapping field + volume render + 2D synthesis
(threedhumangan_tpu/models/generator.py).

``generator_forward`` / ``staged_forward`` (eval) run: the mapping
networks, weak-perspective rays, the geo features
(``models.smpl.get_geo_features``), the field render, a resize of the
feature map, and the synthesis, under no-grad.

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
  pallas_field_bwd (True)   the G step's field backward on K8/K9; False: the
                            remat backward (``ops.raymarch_bwd.FieldRenderRemat``:
                            the K2/K4 forward, then autograd through the
                            unfolded render recomputed, JAX raymarch.py:952-953)

(``ops.raymarch.fused_field_render`` also takes K4 for a field with fewer
than 2 trunk blocks.)  The TPU-only knobs ``pallas_tile_rays``,
``pallas_step_pack``, ``pallas_fold_pipe2``, ``pallas_geo_tile_points``,
``pallas_geo_tile_rays`` and ``pallas_interpret`` size or schedule Pallas
kernels and have no role here.  Nor does ``pallas_synthesis``: the JAX flag
picks its fused synthesis kernel against the per-op eval stack
(JAX ``generator.py:498-504``), two ways to compute the same function, and
the port runs K3 (its plain version on the CPU) wherever the JAX rule
allows it: batch norm or adaptive batch norm without 2D label or latent
input; every other eval synthesis runs the per-op stack
(``SynthesisNetwork.forward(train=False)``), which has no kernel in JAX
either.

The XLA field path (JAX ``generator.py:330-399``) is taken where JAX takes
it: ``pallas_field`` False (the port's default is True on every device),
``hierarchical_sample``, ``clamp_mode`` other than 'relu', or the grad path
with ``pallas_field_train`` False.  The field runs over all points through
``CoordConcatSiren.forward`` (plain PyTorch: JAX computes it in XLA), under
``torch.utils.checkpoint`` with gradients and ``remat_field`` (default
True), then ``ray_integration`` with the nerf noise drawn there.
Hierarchical sampling integrates the detached coarse output with its own
noise, samples as many fine depths per ray by ``sample_pdf``, takes the
fine points' geo features through torch around K6 (``pallas_geo=False``
as JAX, ``pallas_knn`` as set), evaluates the field on them, merges fine
before coarse by a stable sort of depth and integrates the 2S samples.

Nerf noise (``noise_std * randn``) is drawn wherever ``nerf_noise`` (or the
``nerf_noise`` argument) is not 0, at eval as in training: on the kernels'
path it rides as the field render's noise column.  ``draws`` hands in the
draws that the JAX package makes from its own keys, so that a test can
feed the same tensors to both: 'perturb' (uniform, the z samples' shape),
'noise' (standard normal, one a sample of the final integration),
'hier_noise' (standard normal, the coarse samples' shape) and 'pdf'
(uniform, (B * rays, steps)); a key that is absent is drawn from
``generator``.

``generator_forward(train=True)`` is the training forward: the synthesis
runs in train mode (batch moments; the running stats and spectral-norm
``u`` updated in place), per op or, with batch norm and
``meta['pallas_synthesis_train']``, on the fused half-blocks (K10 forward,
K11 backward), and it returns (outputs, the synthesis state).
``pallas_ok=True`` (the D step's fakes, under no-grad) renders with the
selected kernel alone; ``pallas_ok=False`` (the G step) renders through
``ops.raymarch_bwd.FieldRender``, K2 or K4 forward with the K8/K9 backward.

The synthesis variants follow JAX ``generator.py:471-550``:
``disable_render`` takes the feature maps from the condition-image style
head (``SynthesisStyleInput``) with a zero render and depth; the
config-level ``disable_synthesis`` (and the argument of that name, at eval
and in training) returns the render as both images; ``2d_label_input``
concatenates the rasterized labels (``/ label_dim * 2 - 1``) to the
coordinates and ``2d_latent_input`` the broadcast latent after the
synthesis input; ``feature_map_interpolation`` takes every method of
``jax.image.resize`` (``utils.image.resize``; bilinear upsampling stays on
``F.interpolate``).  On a CUDA device every kernel launches; on the CPU
each wrapper runs its plain PyTorch version.  ``remat_synthesis`` (default
True, as in the JAX package) recomputes each synthesis block in the
training backward (``models.synthesis`` docstring); it changes memory and
time, not values.  ``auto_remat_synthesis`` is the trainers' shape-aware
default for it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from threedhumangan_tpu_torch.utils import image, trace
from threedhumangan_tpu_torch.utils.misc import resolve_device, take_draw


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


def resize_feature_maps(x: torch.Tensor, height: int, width: int,
                        method: str = "bilinear") -> torch.Tensor:
    """NHWC resize as ``jax.image.resize(..., method)``: a bilinear (or
    'linear') upsampling is ``F.interpolate`` with half-pixel centres and no
    antialiasing; every other case ``utils.image.resize``."""
    if method in ("bilinear", "linear") and x.shape[1] <= height and x.shape[2] <= width:
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                          align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1).contiguous()
    return image.resize(x, height, width, method)


def xla_field_path(meta: Dict, grad_field: bool) -> bool:
    """True where the JAX package renders on its XLA field path
    (``generator.py:205-210``)."""
    return (not meta.get("pallas_field", True) or meta.get("hierarchical_sample", False)
            or meta["clamp_mode"] != "relu"
            or (grad_field and not meta.get("pallas_field_train", True)))


def _field(gen: Map3DGenerator, meta: Dict, freq, phase, points, geo, dirs, compute_dtype):
    """The field over all points (JAX ``field_apply``): (B, P, 3+F+1) in
    float32, the products in ``compute_dtype`` accumulated in float32; under
    ``torch.utils.checkpoint`` with gradients and ``remat_field``."""
    fn = functools.partial(gen.neural_field, input_scaler=2.0 / meta["side_length"],
                           compute_dtype=compute_dtype, fast_math=meta.get("fast_math", True))
    if torch.is_grad_enabled() and meta.get("remat_field", True):
        return checkpoint(fn, points, freq, phase, geo, dirs, use_reentrant=False)
    return fn(points, freq, phase, geo, dirs)


def _geo(conditions: Dict, meta: Dict, points, pallas_geo: bool, ray_layout):
    f32 = lambda t: t.float().contiguous()
    if meta.get("disable_modulation", False):
        return points.new_zeros(points.shape[0], points.shape[1], meta["geo_feature_dim"])
    return get_geo_features(
        points, f32(conditions["skeletons_xyz"]), f32(conditions["vertices"]),
        f32(conditions["tpose_vertices"]), f32(conditions["fk_matrices"]),
        f32(conditions["lbs_weights"]), legacy_mode=meta.get("legacy_mode", False),
        use_pallas_knn=meta.get("pallas_knn", True), use_pallas_geo=pallas_geo,
        ray_layout=ray_layout)


def render(gen: Map3DGenerator, freq, phase, conditions: Dict, meta: Dict,
           generator: Optional[torch.Generator] = None, compute_dtype=torch.float32,
           stage: Optional[Callable] = None, nerf_noise=None, grad_field: bool = False,
           draws: Optional[Dict] = None):
    """Volume-render the pose-conditioned field.  Returns (rgb_render NHWC,
    feature_maps NHWC, depths (B, rays, 1)).  The nerf noise is
    ``nerf_noise``, else meta's, at eval and in training; ``grad_field``
    renders so that gradients reach the field and freq/phase (the G step);
    ``draws`` as the module docstring says; ``stage`` as
    ``generator_forward``'s."""
    stage = trace.staged(stage)
    noise_std = meta.get("nerf_noise", 0.5) if nerf_noise is None else nerf_noise
    xla = xla_field_path(meta, grad_field)
    # the geo features inside the field render: off the grad path and
    # without disable_modulation (JAX generator.py:215-220)
    fuse_geo = (not xla and meta.get("pallas_fuse_geo", False) and not grad_field
                and not meta.get("disable_modulation", False))
    render_w, render_h, S = meta["render_width"], meta["render_height"], meta["num_steps"]
    B = freq.shape[0]
    R = render_w * render_h
    with stage("rays"):
        focals = conditions["intrinsics"][:, 0, 0]
        scales = conditions["scales"].float()
        points_cam, z_vals, rays_d_cam = vr.get_initial_rays_weak_perspective(
            focals, scales, S, (render_w, render_h), meta["ray_start"], meta["ray_end"])
        points, z_vals, ray_dirs, origins = vr.transform_sampled_points(
            points_cam, z_vals, rays_d_cam, conditions["cam2world_matrices"], generator,
            perturb=meta.get("perturb_rays", True),
            perturb_u=None if draws is None else draws.get("perturb"))
        points = points.reshape(B, R * S, 3)
        dirs = vr.expand_ray_directions(ray_dirs, S)
        if meta.get("lock_view_dependence", False):
            dirs = torch.zeros_like(dirs)
            dirs[..., -1] = -1.0
    f32 = lambda t: t.float().contiguous()
    with stage("geo"):
        if fuse_geo:  # only the per-vertex [inverse-FK 16; T-pose 3] table
            vfeat = build_vertex_features(conditions["tpose_vertices"], conditions["fk_matrices"],
                                          conditions["lbs_weights"])
        else:
            geo = _geo(conditions, meta, points, meta.get("pallas_geo", True), (render_w, S))
    if xla:
        render_out, depths = _render_xla(gen, meta, freq, phase, conditions, points, geo, dirs,
                                         z_vals, ray_dirs, origins, noise_std, generator,
                                         compute_dtype, stage, draws)
    else:
        with stage("field"):
            noise = None
            if noise_std != 0:
                noise = noise_std * take_draw(draws, "noise", lambda: torch.randn(
                    B, points.shape[1], 1, generator=generator, device=points.device)).reshape(
                        B, points.shape[1], 1)
            z_flat = z_vals.reshape(B, R, S)
            kw = dict(white_back=meta.get("white_back", False),
                      last_back=meta.get("last_back", False),
                      compute_dtype=compute_dtype, exact_sin=not meta.get("fast_math", True))
            if fuse_geo:
                packed = torch.cat([points, dirs] + ([noise] if noise is not None else []), -1)
                render_out, depths = fused_field_render_geo(
                    gen.neural_field, packed, freq, phase, z_flat, f32(conditions["vertices"]),
                    vfeat, f32(conditions["skeletons_xyz"]), S, 2.0 / meta["side_length"],
                    legacy_mode=meta.get("legacy_mode", False), **kw)
            else:
                packed = pack_field_inputs(points, geo, dirs, 2.0 / meta["side_length"],
                                           noise=noise)
                # the JAX loop-mode kernel is the unfolded one: both select K4
                fold = (meta.get("pallas_fold_film", True)
                        and not meta.get("pallas_march_loop", False))
                if grad_field:
                    render_out, depths = field_render_trainable(
                        gen.neural_field, packed, freq, phase, z_flat, S, fold_film=fold,
                        pallas_bwd=meta.get("pallas_field_bwd", True), **kw)
                else:
                    render_out, depths = fused_field_render(gen.neural_field, packed, freq,
                                                            phase, z_flat, S, fold_film=fold,
                                                            **kw)
    render_out = render_out.reshape(B, render_h, render_w, -1)
    return render_out[..., :3] * 2.0 - 1.0, render_out[..., 3:], depths


def _render_xla(gen, meta, freq, phase, conditions, points, geo, dirs, z_vals, ray_dirs,
                origins, noise_std, generator, compute_dtype, stage, draws):
    """The XLA field path (JAX ``generator.py:330-399``): returns (render
    (B, rays, 3+F), depths (B, rays, 1))."""
    render_w, S = meta["render_width"], meta["num_steps"]
    B, R = z_vals.shape[0], z_vals.shape[1]
    F_out = gen.neural_field.feature_layer_linear.out_features + 4
    clamp = meta["clamp_mode"]
    randn = lambda *shape: torch.randn(*shape, generator=generator, device=points.device)
    with stage("field"):
        coarse = _field(gen, meta, freq, phase, points, geo, dirs, compute_dtype)
        coarse = coarse.reshape(B, R, S, F_out)
    z_int, field_out = z_vals, coarse
    if meta.get("hierarchical_sample", False):
        with stage("pdf"), torch.no_grad():
            hier = None
            if noise_std != 0:
                hier = take_draw(draws, "hier_noise", lambda: randn(B, R, S, 1)).reshape(B, R, S, 1)
            _, _, c_weights = vr.ray_integration(coarse.detach(), z_vals, noise_std=noise_std,
                                                 noise=hier, clamp_mode=clamp)
            w_flat = c_weights.reshape(B * R, S) + 1e-5
            z_flat = z_vals.reshape(B * R, S)
            z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
            u = take_draw(draws, "pdf", lambda: torch.rand(B * R, S, generator=generator,
                                                           device=points.device))
            fine_z = vr.sample_pdf(z_mid, w_flat[:, 1:-1], S, u=u).reshape(B, R, S, 1)
            fine_points = (origins[:, :, None, :] + ray_dirs[:, :, None, :] * fine_z).reshape(
                B, R * S, 3)
        with stage("fine_geo"), torch.no_grad():
            fine_geo = _geo(conditions, meta, fine_points, False, (render_w, S))
        with stage("fine_field"):
            fine = _field(gen, meta, freq, phase, fine_points, fine_geo, dirs, compute_dtype)
            fine = fine.reshape(B, R, S, F_out)
        with stage("merge"):
            # fine before coarse, then a stable sort by depth (jnp.argsort)
            z_int = torch.cat([fine_z, z_vals], -2)
            field_out = torch.cat([fine, coarse], -2)
            _, order = torch.sort(z_int[..., 0], dim=-1, stable=True)
            z_int = torch.gather(z_int, 2, order[..., None])
            field_out = torch.gather(field_out, 2,
                                     order[..., None].expand(-1, -1, -1, field_out.shape[-1]))
    with stage("integrate"):
        noise = None
        if noise_std != 0:
            noise = take_draw(draws, "noise", lambda: randn(*z_int.shape)).reshape(z_int.shape)
        render_out, depths, _ = vr.ray_integration(
            field_out, z_int, noise_std=noise_std, noise=noise,
            white_back=meta.get("white_back", False), last_back=meta.get("last_back", False),
            clamp_mode=clamp)
    return render_out, depths


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
                      stage: Optional[Callable] = None, train: bool = False, nerf_noise=None,
                      latent_indices=None, pallas_ok: bool = True,
                      disable_synthesis: bool = False, draws: Optional[Dict] = None):
    """Eval forward (``train=False``): returns {'rgbs', 'rgbs_render'} NHWC
    in [-1, 1], plus 'depths' and 'skeletons' when ``with_depth``.  Train
    forward: returns ({'rgbs', 'rgbs_render'}, synthesis state), see the
    module docstring.  ``disable_synthesis`` (or meta's; a render-modal
    phase in training) skips the mapping to styles, the resize and the
    synthesis and returns the render as both images, with the synthesis
    state untouched.  ``draws``: the module docstring.  The forward is the
    span ``generator.forward`` (``utils.trace``; a unit's root outside a
    training pair) and each stage the span of its name, around the caller's
    ``stage(name)`` hook where one is given (a context manager, for
    timing)."""
    disable_synthesis = disable_synthesis or meta.get("disable_synthesis", False)
    stage = trace.staged(stage)
    with trace.span("generator.forward", unit=True):
        if train:
            return _train_forward(gen, z, conditions, meta, generator, compute_dtype, nerf_noise,
                                  latent_indices, pallas_ok, stage, disable_synthesis, draws)
        return _eval_forward(gen, z, conditions, meta, generator, compute_dtype, truncation_psi,
                             avg_latent, with_depth, stage, disable_synthesis, nerf_noise, draws)


def _mapping(gen, meta, latent, compute_dtype, disable_synthesis):
    """(freq, phase), or None under ``disable_render``, and the styles, or
    None under ``disable_synthesis``."""
    film = styles = None
    if not meta.get("disable_render", False):
        field_latent = (latent if meta.get("neural_field_latent_input", True)
                        else torch.zeros_like(latent))
        film = gen.neural_field_mapping_network(field_latent, compute_dtype)
    if not disable_synthesis:
        _, styles = gen.synthesis_mapping_network(latent, compute_dtype)
    return film, styles


def _render_or_condition(gen, meta, conditions, film, latent, generator, compute_dtype, stage,
                         nerf_noise, grad_field, draws):
    """(rgb_render, feature_maps, depths): the field render, or under
    ``disable_render`` the condition-image style head's feature maps with a
    zero render and depth (JAX ``generator.py:450-466``)."""
    if not meta.get("disable_render", False):
        return render(gen, *film, conditions, meta, generator, compute_dtype, stage,
                      nerf_noise=nerf_noise, grad_field=grad_field, draws=draws)
    B = latent.shape[0]
    rh, rw = meta["render_height"], meta["render_width"]
    with stage("condition"):
        modal = meta["condition_modal_gen"]
        condition = conditions[modal]
        if "segments" in modal:
            condition = condition[..., None].to(latent.dtype) / (meta["label_dim"] - 1) * 2 - 1
        lat = latent if meta.get("spade_latent_input", True) else torch.zeros_like(latent)
        feature_maps = gen.synthesis_style_input(condition, lat, compute_dtype)
    return (latent.new_zeros(B, rh, rw, 3), feature_maps, latent.new_zeros(B, rh * rw, 1))


def _synthesis_input(gen, meta, conditions, latent, B, gen_h, gen_w, compute_dtype):
    """The synthesis input: sin(conv1x1(coords)), the coordinates with the
    rasterized labels (``2d_label_input``: / label_dim * 2 - 1) and the
    broadcast latent after it (``2d_latent_input``)."""
    coords = syn.get_2d_coords(B, gen_h, gen_w, device=latent.device)
    if meta.get("2d_label_input", False):
        label = conditions["rasterized_segments"][..., None] / meta["label_dim"] * 2 - 1
        coords = torch.cat([coords, label.to(coords.dtype)], -1)
    x = gen.synthesis_input(coords, compute_dtype)
    if meta.get("2d_latent_input", False):
        lat = latent[:, None, None, :].expand(B, gen_h, gen_w, latent.shape[-1])
        x = torch.cat([x, lat.to(x.dtype)], -1)
    return x


def _train_forward(gen, z, conditions, meta, generator, compute_dtype, nerf_noise,
                   latent_indices, pallas_ok, stage, disable_synthesis, draws):
    B = z.shape[0]
    latent = z if latent_indices is None else gen.latent_pool.latents[latent_indices.long()]
    with stage("mapping"):
        film, styles = _mapping(gen, meta, latent, compute_dtype, disable_synthesis)
    rgb_render, feature_maps, _ = _render_or_condition(
        gen, meta, conditions, film, latent, generator, compute_dtype, stage, nerf_noise,
        not pallas_ok, draws)
    if disable_synthesis:  # the render is the output; the feature channels get no cotangent
        return ({"rgbs": rgb_render, "rgbs_render": rgb_render},
                dict(gen.synthesis_network.named_buffers()))
    gen_h, gen_w = meta["gen_height"], meta["gen_width"]
    with stage("resize"):
        feature_maps = resize_feature_maps(feature_maps.to(compute_dtype), gen_h, gen_w,
                                           meta.get("feature_map_interpolation", "bilinear"))
    with stage("synthesis"):
        x = _synthesis_input(gen, meta, conditions, latent, B, gen_h, gen_w, compute_dtype)
        # pallas_synthesis_train (the JAX key) picks the fused half-blocks,
        # K10 forward / K11 backward, under batch norm; the JAX TPU-only keys
        # pallas_synthesis_train_tile_rows and pallas_interpret have no role here
        rgbs = gen.synthesis_network(x, feature_maps, styles, compute_dtype, train=True,
                                     fused=meta.get("pallas_synthesis_train", False),
                                     remat=meta.get("remat_synthesis", True))
    return ({"rgbs": rgbs, "rgbs_render": rgb_render},
            dict(gen.synthesis_network.named_buffers()))


def fused_synthesis_eval(meta: Dict, normalization: str) -> bool:
    """The JAX rule for its fused eval synthesis (``generator.py:498-504``)
    without the ``pallas_synthesis`` flag: K3 runs batch norm or adaptive
    batch norm without 2D label or latent input."""
    return (normalization in ("batch_norm", "adaptive_batch_norm")
            and not meta.get("2d_label_input", False) and not meta.get("2d_latent_input", False))


@torch.no_grad()
def _eval_forward(gen, z, conditions, meta, generator, compute_dtype, truncation_psi,
                  avg_latent, with_depth, stage, disable_synthesis, nerf_noise, draws):
    B = z.shape[0]
    gen_h, gen_w = meta["gen_height"], meta["gen_width"]
    render_h, render_w = meta["render_height"], meta["render_width"]
    latent = z
    with stage("mapping"):
        film, styles = _mapping(gen, meta, latent, compute_dtype, False)
        if truncation_psi < 1.0:
            if avg_latent is None:
                avg_latent = generate_avg_latent(gen, meta, generator, device=z.device)
            avg_z, avg_freq, avg_phase, avg_styles = avg_latent
            if film is not None:
                film = tuple(a + truncation_psi * (x - a)
                             for x, a in zip(film, (avg_freq, avg_phase)))
            latent = avg_z + truncation_psi * (latent - avg_z)
            styles = avg_styles + truncation_psi * (styles - avg_styles)

    rgb_render, feature_maps, depths = _render_or_condition(
        gen, meta, conditions, film, latent, generator, compute_dtype, stage, nerf_noise, False,
        draws)

    if disable_synthesis:
        output = {"rgbs": rgb_render, "rgbs_render": rgb_render}
    else:
        with stage("resize"):
            feature_maps = resize_feature_maps(feature_maps.to(compute_dtype), gen_h, gen_w,
                                               meta.get("feature_map_interpolation", "bilinear"))
        with stage("synthesis"):
            net = gen.synthesis_network
            norm = net.spatial_normalization
            if fused_synthesis_eval(meta, norm):
                with trace.span("synthesis.glue"):  # K3's operands: here and in its wrapper
                    folded = fold_synthesis_params(net, gen.synthesis_input, norm)
                rgbs = fused_synthesis(folded, feature_maps, styles, meta["synthesis_blocks"],
                                       tuple(meta["mod_blocks"]),
                                       meta.get("map3d_mode", "isolated"), compute_dtype)
            else:
                x = _synthesis_input(gen, meta, conditions, latent, B, gen_h, gen_w,
                                     compute_dtype)
                rgbs = net(x, feature_maps, styles, compute_dtype)
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
                   compute_dtype=torch.float32, stage: Optional[Callable] = None) -> Dict:
    """Inference entry: truncation from ``meta['truncation_psi']`` and depth."""
    psi = meta.get("truncation_psi", 1.0) if truncation_psi is None else truncation_psi
    return generator_forward(gen, z, conditions, meta, generator, compute_dtype=compute_dtype,
                             truncation_psi=psi, avg_latent=avg_latent, with_depth=True,
                             stage=stage)
