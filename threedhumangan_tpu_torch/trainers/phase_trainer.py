"""PhaseTrainer steps (threedhumangan_tpu/trainers/phase_trainer.py).

``d_train_step``: preprocess (camera + K7 rasterizer) -> generator forward
in train mode under no-grad (K1, K2) -> D(real), D(fake) with spectral-norm
updates -> balanced segmentation CE (+ the GAN / latent terms when
configured) -> R1 on the real input (x4, on ``do_r1`` phases, with the
discriminator's pre-step ``u``) -> clip -> Adam.

``g_train_step``: preprocess -> generator forward with gradients (the field
through ``FieldRender``: K2 forward, K8/K9 backward) -> D(fake) -> CE
against the chosen ground-truth segments -> clip -> Adam with the five
generator lr groups -> EMA.  ``train_step_pair`` runs one of each.

Modules are updated in place: ``TrainState`` holds the generator,
discriminator, their optimizers, the EMA and the step count.  Randomness
comes from a ``torch.Generator``; each step also takes an optional ``draws``
mapping — ``z`` (B, latent), ``coin`` (the uniform draw that picks
rasterized vs annotated segments) and ``h_rotation``/``v_rotation`` (B,) —
which replaces the generator's draws of those values, so a test can feed
in the JAX package's.  Gradients are taken with ``torch.autograd.grad`` for
the stepped module only.  ``batch_split > 1`` runs micro-batches with
losses divided by the split count (gradient accumulation).  Not ported:
ADA (``ada_interval > 0``), the perceptual and photometric losses, dual
discrimination and render-modal discrimination; each raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator
from threedhumangan_tpu_torch.models.generator import Map3DGenerator, generator_forward
from threedhumangan_tpu_torch.parallel.stats import moments
from threedhumangan_tpu_torch.trainers import losses as L
from threedhumangan_tpu_torch.trainers.optim import (
    adam_step,
    generator_lr_multipliers,
    make_adam,
    param_groups,
)
from threedhumangan_tpu_torch.utils.ema import ema_init, ema_update
from threedhumangan_tpu_torch.utils.misc import normalize_2nd_moment, resolve_device


@dataclasses.dataclass
class TrainState:
    G: Map3DGenerator
    D: UNetDiscriminator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    ema: Dict
    step: int = 0


def make_optimizers(G, D, meta: Dict):
    betas = tuple(meta["betas"])
    return (make_adam(param_groups(G, generator_lr_multipliers(meta)), betas),
            make_adam(param_groups(D), betas))


def init_train_state(meta: Dict, generator: torch.Generator, device="cuda") -> TrainState:
    """Random G and D from ``generator`` (the JAX inits' distributions) on ``device``."""
    device = resolve_device(device)
    G = Map3DGenerator(meta, generator).to(device)
    D = UNetDiscriminator(meta, generator).to(device)
    opt_G, opt_D = make_optimizers(G, D, meta)
    return TrainState(G, D, opt_G, opt_D, ema_init(G))


def compute_dtype(meta: Dict):
    return torch.bfloat16 if meta.get("use_mixed_precision", False) else torch.float32


def _check_meta(meta: Dict, phase: Dict):
    if meta.get("ada_interval", 0):
        raise NotImplementedError("ADA (ada_interval > 0)")
    if meta.get("dual_discrimination", False) or phase["gen_modal"] != "rgbs":
        raise NotImplementedError("dual / render-modal discrimination")
    if sum(meta.get("perceptual_lambda", [0])) > 0 or meta.get("photometric_lambda", 0) > 0:
        raise NotImplementedError("perceptual / photometric losses")


def _preprocess(preprocessor, data, rotate: bool, generator, draws):
    if draws is not None and "h_rotation" in draws:
        h, v = draws["h_rotation"], draws["v_rotation"]
        return preprocessor.forward_with_rotation(data, h, v, torch.zeros_like(h))
    return preprocessor(data, rotate, generator)


def _draw(draws, key, make):
    return make() if draws is None or key not in draws else draws[key]


def _choose_segments(coin, rotate: bool, rasterized, body, p: float = 0.5):
    """Rotated phases use the rasterized labels (the annotations no longer
    align); otherwise a coin picks: rasterized when coin < p."""
    use_raster = torch.as_tensor(coin < p) | bool(rotate)
    return torch.where(use_raster.to(rasterized.device), rasterized, body)


@contextlib.contextmanager
def _swapped_buffers(module: torch.nn.Module, buffers: Dict[str, torch.Tensor]):
    """Run with ``buffers`` in place of the module's, then restore."""
    current = dict(module.named_buffers())
    saved = {k: current[k].clone() for k in buffers}
    with torch.no_grad():
        for k, v in buffers.items():
            current[k].copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                current[k].copy_(v)


def _group_norm_stats(module, params, grads, prefix: str) -> Dict:
    """Global norm of the grads of each top-level submodule (as moments)."""
    names = {id(p): n for n, p in module.named_parameters()}
    groups: Dict[str, list] = {}
    for p, t in zip(params, grads):
        groups.setdefault(names[id(p)].split(".")[0], []).append(t)
    return {f"{prefix}/{k}": moments(torch.sqrt(sum(torch.sum(torch.square(t.float()))
                                                     for t in ts)))
            for k, ts in groups.items()}


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def _opt_params(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def _split(x, n, i):
    """Micro-batch i of n along the batch axis."""
    return x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]


def d_train_step(ts: TrainState, data: Dict, generator: torch.Generator, lr: float,
                 nerf_noise: float, preprocessor, meta: Dict, phase: Dict,
                 draws: Optional[Dict] = None, stage=None):
    """One discriminator step, in place; returns (ts, stats)."""
    _check_meta(meta, phase)
    stage = stage or (lambda name: contextlib.nullcontext())
    cdt = compute_dtype(meta)
    gan_lambda, seg_lambda = meta["gan_lambda"], meta["segmentation_lambda"]
    latent_lambda = meta.get("latent_lambda", 0)
    label_dim = meta["label_dim"]
    mode = meta.get("segmentation_loss_mode", "cross_entropy_balanced")
    prior = meta.get("segmentation_weights")
    G, D = ts.G, ts.D
    dev = data["images"].device

    with stage("preprocess"):
        data = _preprocess(preprocessor, data, phase["rotate"], generator, draws)
    real_images = data["images"]
    B = real_images.shape[0]
    z = _draw(draws, "z", lambda: torch.randn(B, meta["latent_dim"], generator=generator,
                                              device=dev))
    coin = _draw(draws, "coin", lambda: torch.rand((), generator=generator, device=dev))
    real_segments = _choose_segments(coin, phase["rotate"], data["rasterized_segments"],
                                     data["body_segments"].to(torch.int32))

    n_split = int(meta.get("batch_split", 1))
    with stage("d_fakes"), torch.no_grad():
        outs = []
        for i in range(n_split):
            data_c = {k: _split(v, n_split, i) for k, v in data.items()}
            out, _ = generator_forward(
                G, _split(z, n_split, i), data_c, meta, generator, cdt, train=True,
                nerf_noise=nerf_noise,
                latent_indices=None if phase["uncond"] else data_c["indices"])
            outs.append(out[phase["gen_modal"]])
        fake_images = torch.cat(outs, 0)

    with stage("d_step"):
        u0 = {k: v.clone() for k, v in D.named_buffers()}
        out_real = D(real_images, cdt, train=True)
        out_fake = D(fake_images, cdt, train=True)
        pred_real, pred_fake = out_real["prediction"].float(), out_fake["prediction"].float()
        stats = {}
        if gan_lambda > 0:
            gan = gan_lambda * L.gan_loss_d(pred_real, pred_fake)
            stats["real_signs"] = moments(torch.sign(pred_real))
        else:
            gan = 0.0 * (pred_real.sum() + pred_fake.sum())
        if seg_lambda > 0:
            seg_real, acc_real, prob_real = L.segmentation_loss(
                out_real["segments"].float(), real_segments, label_dim, mode, prior)
            seg_fake, _, prob_fake = L.segmentation_loss(
                out_fake["segments"].float(), torch.zeros_like(real_segments), label_dim, mode,
                prior)
            seg = (seg_real + seg_fake) * seg_lambda
            stats.update(d_segmentation_loss=moments(seg), segmentation_acc_real=moments(acc_real),
                         segmentation_prob_real=moments(prob_real),
                         segmentation_prob_gen=moments(prob_fake))
        else:
            seg = 0.0 * (out_real["segments"].float().sum() + out_fake["segments"].float().sum())
        if latent_lambda > 0:
            nm = lambda x: normalize_2nd_moment(x.float())
            lat = latent_lambda * (L.smooth_l1(nm(out_fake["latents"]), nm(z))
                                   + L.smooth_l1(nm(out_real["latents"]), nm(data["latents"])))
            stats["d_latent_loss"] = moments(lat)
        else:
            lat = 0.0 * (out_real["latents"].float().sum() + out_fake["latents"].float().sum())
        r1 = 0.0
        if meta["r1_lambda"] > 0 and phase["do_r1"]:
            # R1 through the discriminator as it was before this step's
            # spectral-norm updates (the JAX step passes ts.state_D)
            with stage("d_r1"), _swapped_buffers(D, u0):
                r1 = 4.0 * L.r1_regularization(lambda img: D(img, cdt, train=False), real_images,
                                               meta["r1_lambda"], gan_lambda, seg_lambda)
            stats["r1"] = moments(r1 / 4.0)
        loss = gan + seg + lat + r1
        stats["d_loss"] = moments(loss)
        params = _opt_params(ts.opt_D)
        grads = _grads(loss, params)
    stats.update(_group_norm_stats(D, params, grads, "d_grad_norm"))
    with stage("d_optimizer"):
        adam_step(ts.opt_D, grads, lr, meta.get("grad_clip", 0.0))
    return ts, stats


def g_train_step(ts: TrainState, data: Dict, generator: torch.Generator, lr: float,
                 nerf_noise: float, preprocessor, meta: Dict, phase: Dict,
                 draws: Optional[Dict] = None, stage=None):
    """One generator step with the EMA update, in place; returns (ts, stats)."""
    _check_meta(meta, phase)
    stage = stage or (lambda name: contextlib.nullcontext())
    cdt = compute_dtype(meta)
    gan_lambda = meta["gan_lambda"] if phase["uncond"] else 0
    seg_lambda = meta["segmentation_lambda"]
    latent_lambda = meta.get("latent_lambda", 0)
    label_dim = meta["label_dim"]
    mode = meta.get("segmentation_loss_mode", "cross_entropy_balanced")
    prior = meta.get("segmentation_weights")
    G, D = ts.G, ts.D
    dev = data["images"].device

    with stage("preprocess"):
        data = _preprocess(preprocessor, data, phase["rotate"], generator, draws)
    B = data["images"].shape[0]
    z = _draw(draws, "z", lambda: torch.randn(B, meta["latent_dim"], generator=generator,
                                              device=dev))
    coin = _draw(draws, "coin", lambda: torch.rand((), generator=generator, device=dev))
    gt_segments = _choose_segments(coin, phase["rotate"], data["rasterized_segments"],
                                   data["body_segments"].to(torch.int32))

    n_split = int(meta.get("batch_split", 1))
    params = _opt_params(ts.opt_G)
    grads = None
    stats: Dict[str, torch.Tensor] = {}
    for i in range(n_split):
        data_c = {k: _split(v, n_split, i) for k, v in data.items()}
        z_c = _split(z, n_split, i)
        with stage("g_forward"):
            gen_out, _ = generator_forward(
                G, z_c, data_c, meta, generator, cdt, train=True, nerf_noise=nerf_noise,
                latent_indices=None if phase["uncond"] else data_c["indices"], pallas_ok=False)
            out = D(gen_out[phase["gen_modal"]], cdt, train=True)
            pred = out["prediction"].float()
            st = {}
            if gan_lambda > 0:
                gan = gan_lambda * L.gan_loss_g_topk(pred, ts.step, meta)
                st["gen_signs"] = moments(torch.sign(pred))
            else:
                gan = 0.0 * pred.sum()
            if seg_lambda > 0:
                seg = seg_lambda * L.segmentation_loss(out["segments"].float(),
                                                       _split(gt_segments, n_split, i),
                                                       label_dim, mode, prior)[0]
                st["g_segmentation_loss"] = moments(seg)
            else:
                seg = 0.0 * out["segments"].float().sum()
            if latent_lambda > 0:
                nm = lambda x: normalize_2nd_moment(x.float())
                if phase["uncond"]:
                    gt_lat = nm(z_c)
                else:
                    gt_lat = nm(G.latent_pool.latents[data_c["indices"].long()]).detach()
                lat = L.smooth_l1(nm(out["latents"]), gt_lat)
                if not phase["uncond"]:
                    lat = lat + L.smooth_l1(z_c, data_c["latents"])
                lat = latent_lambda * lat
                st["g_latent_loss"] = moments(lat)
            else:
                lat = 0.0 * out["latents"].float().sum()
            loss = gan + seg + lat
            st["g_loss"] = moments(loss)
        with stage("g_backward"):
            g = _grads(loss / n_split, params)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for k, v in st.items():
            stats[k] = stats[k] + v if k in stats else v
    stats.update(_group_norm_stats(G, params, grads, "g_grad_norm"))
    with stage("g_optimizer"):
        adam_step(ts.opt_G, grads, lr, meta.get("grad_clip", 0.0))
        ema_update(ts.ema, G)
    ts.step += 1
    return ts, stats


def train_step_pair(ts: TrainState, data: Dict, generator: torch.Generator, meta: Dict,
                    preprocessor, phase: Dict, lr_g: float, lr_d: float, nerf_noise: float,
                    draws: Optional[Dict] = None, stage=None):
    """One training iteration: a D step, then a G step."""
    d_draws = None if draws is None else draws.get("d")
    g_draws = None if draws is None else draws.get("g")
    ts, d_stats = d_train_step(ts, data, generator, lr_d, nerf_noise, preprocessor, meta, phase,
                               d_draws, stage)
    ts, g_stats = g_train_step(ts, data, generator, lr_g, nerf_noise, preprocessor, meta, phase,
                               g_draws, stage)
    return ts, {**d_stats, **g_stats}
