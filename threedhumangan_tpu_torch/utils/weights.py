"""Move JAX weights and training state into the port.

``from_jax_params(params, state)`` takes the JAX package's generator pytrees
(``init_generator`` / ``convert_generator_state_dict`` layout) as numpy
arrays and returns the port's ``state_dict`` — the reference torch key space,
so ``threedhumangan_tpu.utils.torch_convert.convert_generator_state_dict``
maps it straight back.  Layouts: JAX Linear / 1x1-conv weights are (in, out)
and become (out, in[, 1, 1]); the equalised-lr FC weights stay (out, in)
(their gains are recomputed from the shapes).  ``discriminator_state``
does the same for the U-Net discriminator (HWIO convs become OIHW, with
their spectral-norm ``u``), and ``train_state_from_jax`` builds the port's
G, D, optimizers and EMA from a JAX ``TrainState``.  ``inception_from_jax``
and ``vgg16_from_jax`` carry the feature extractors' weights across.  No JAX
import: any array with ``numpy.asarray`` support is accepted.

The apps load weights with ``load_torch_state_dict`` +
``load_generator_state_dict`` (a reference-key-space file: the released
checkpoint loads with no converter) or ``load_trainer_checkpoint`` (the
port's own ``Trainer`` checkpoint, EMA parameters).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from threedhumangan_tpu_torch.utils.misc import resolve_device


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _lin(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    sd[prefix + ".bias"] = _t(p["b"])


def _conv(sd, prefix, p, weight_name="weight"):
    sd[f"{prefix}.{weight_name}"] = _t(np.asarray(p["w"]).T[:, :, None, None])
    sd[prefix + ".bias"] = _t(p["b"])


def neural_field_state(nf: Dict) -> Dict[str, torch.Tensor]:
    """JAX COORDCONCATSIREN params -> ``CoordConcatSiren`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _lin(sd, "first_layer_coord.layer", nf["first_coord"])
    _lin(sd, "first_layer_mod.layer", nf["first_mod"])
    for i, layer in enumerate(nf["network"]):
        _lin(sd, f"network.{i}.layer", layer)
    _lin(sd, "sigma_layer", nf["sigma"])
    _lin(sd, "color_layer_sine.layer", nf["color_sine"])
    _lin(sd, "color_layer_linear", nf["color_linear"])
    _lin(sd, "feature_layer_linear", nf["feature_linear"])
    return sd


def synthesis_input_state(p: Dict) -> Dict[str, torch.Tensor]:
    """JAX synthesis-input params -> ``SynthesisInput`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "network.0", p["first"])
    return sd


def synthesis_network_state(sn: Dict, sn_state: Dict) -> Dict[str, torch.Tensor]:
    """JAX synthesis-network (params, state) -> ``SynthesisNetwork`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for b, (bp, bs) in enumerate(zip(sn["blocks"], sn_state["blocks"])):
        pre = f"network.m3d_{b}"
        for c in ("conv_0", "conv_1"):
            _conv(sd, f"{pre}.{c}", bp[c], "weight_orig")
            sd[f"{pre}.{c}.weight_u"] = _t(bs[c]["u"])
        for s in ("spade_0", "spade_1"):
            sp, ss = bp[s], bs[s]
            _conv(sd, f"{pre}.{s}.mlp_shared.0", sp["mlp_shared"])
            _conv(sd, f"{pre}.{s}.mlp_gamma", sp["mlp_gamma"])
            _conv(sd, f"{pre}.{s}.mlp_beta", sp["mlp_beta"])
            if "norm" in sp:
                sd[f"{pre}.{s}.first_norm.weight"] = _t(sp["norm"]["scale"])
                sd[f"{pre}.{s}.first_norm.bias"] = _t(sp["norm"]["bias"])
            if "norm" in ss:
                sd[f"{pre}.{s}.first_norm.running_mean"] = _t(ss["norm"]["mean"])
                sd[f"{pre}.{s}.first_norm.running_var"] = _t(ss["norm"]["var"])
                sd[f"{pre}.{s}.first_norm.num_batches_tracked"] = _t(
                    np.asarray(ss["norm"]["count"], np.int64))
    for b, p in enumerate(sn["to_rgbs"]):
        _conv(sd, f"to_rgbs.m3d_{b}.linear", p)
    return sd


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def from_jax_params(params: Dict, state: Dict, module: torch.nn.Module | None = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX (params, state) -> port state_dict; loaded into ``module`` when given."""
    sd: Dict[str, torch.Tensor] = {}
    sd.update(_prefixed("neural_field", neural_field_state(params["neural_field"])))
    sd.update(_prefixed("synthesis_input", synthesis_input_state(params["synthesis_input"])))
    ssi = params["synthesis_style_input"]
    _conv(sd, "synthesis_style_input.from_coords.0", ssi["from_coords"])
    for j, layer in enumerate(ssi["network"]):
        _conv(sd, f"synthesis_style_input.network.{2 * j}", layer)
    sd.update(_prefixed("synthesis_network", synthesis_network_state(
        params["synthesis_network"], state["synthesis_network"])))
    for i, layer in enumerate(params["neural_field_mapping_network"]["layers"]):
        _lin(sd, f"neural_field_mapping_network.network.{2 * i}", layer)
    tpm = params["synthesis_mapping_network"]
    for name in ("trunk", "implicit", "superres"):
        for i, p in enumerate(tpm[name]):
            sd[f"synthesis_mapping_network.{name}{i}.weight"] = _t(p["w"])
            sd[f"synthesis_mapping_network.{name}{i}.bias"] = _t(p["b"])
    sd["latent_pool.latents"] = _t(params["latent_pool"])

    if module is not None:
        module.load_state_dict(sd, strict=True)
    return sd


def _hwio(sd, prefix, p, u=None):
    name = "weight" if u is None else "weight_orig"
    sd[f"{prefix}.{name}"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = _t(p["b"])
    if u is not None:
        sd[prefix + ".weight_u"] = _t(u["u"])


def discriminator_state(params: Dict, state: Dict) -> Dict[str, torch.Tensor]:
    """JAX discriminator (params, state) -> ``UNetDiscriminator`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for part in ("down", "up"):
        for i, (bp, bs) in enumerate(zip(params[part], state[part])):
            for c in ("conv1", "conv2", "conv_s"):
                if c in bp:
                    _hwio(sd, f"{part}.{i}.{c}", bp[c], bs[c])
    for head in ("layer_up_last", "output_layer", "latent_layer"):
        _hwio(sd, head, params[head])
    return sd


def train_state_from_jax(ts, meta: Dict, device="cuda"):
    """A JAX ``TrainState`` (params_G, state_G, params_D, state_D, ema, step;
    any array type) -> the port's ``TrainState`` on ``device``, with fresh
    optimizers (the JAX Adam moments are not carried over)."""
    from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator
    from threedhumangan_tpu_torch.models.generator import Map3DGenerator
    from threedhumangan_tpu_torch.trainers.phase_trainer import TrainState, make_optimizers

    device = resolve_device(device)
    G = Map3DGenerator(meta)
    from_jax_params(ts.params_G, ts.state_G, G)
    D = UNetDiscriminator(meta)
    D.load_state_dict(discriminator_state(ts.params_D, ts.state_D), strict=True)
    G, D = G.to(device), D.to(device)
    ema_sd = from_jax_params(ts.ema["params"], ts.state_G)
    ema = {"params": {k: ema_sd[k].to(device) for k, _ in G.named_parameters()},
           "count": int(np.asarray(ts.ema["count"]))}
    opt_G, opt_D = make_optimizers(G, D, meta)
    return TrainState(G, D, opt_G, opt_D, ema, int(np.asarray(ts.step)))


def inception_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``utils/inception.py`` weights ({name.w HWIO, name.b}) -> the
    port's (``utils.inception``: OIHW), on the CPU."""
    return {k: _t(np.asarray(v).transpose(3, 2, 0, 1) if k.endswith(".w") else v).float()
            for k, v in params.items()}


def vgg16_from_jax(convs) -> list:
    """JAX ``trainers/perceptual.py`` convs ([{w HWIO, b}]) -> the port's
    ([{w OIHW, b}]), on the CPU."""
    return [{"w": _t(np.asarray(c["w"]).transpose(3, 2, 0, 1)).float(), "b": _t(c["b"]).float()}
            for c in convs]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A generator state_dict in the reference torch key space (the released
    EMA checkpoint, or one the port saved with ``torch.save``), tensors on
    the CPU; read with ``weights_only=True``, so nothing but tensors and
    containers is unpickled."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _fit_latent_pool(gen: torch.nn.Module, latents: torch.Tensor):
    """Size ``gen``'s latent pool as ``latents``: the pool has a row per item
    of the training data, and an app builds G for its own dataset length."""
    pool = gen.latent_pool.latents
    if pool.shape != latents.shape:
        gen.latent_pool.latents = torch.nn.Parameter(pool.new_zeros(latents.shape))


def load_generator_state_dict(gen: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """Load a reference-key-space state_dict into ``gen``.  Torch's spectral
    norm also saves ``weight_v``, which the port does not keep (it forms the
    norm from ``u``, as the JAX package's converter does); a state_dict
    without ``latent_pool.latents`` leaves the pool as it is.  Any other
    missing or unknown key raises."""
    sd = {k: v for k, v in sd.items() if not k.endswith(".weight_v")}
    if "latent_pool.latents" in sd:
        _fit_latent_pool(gen, sd["latent_pool.latents"])
    missing, unknown = gen.load_state_dict(sd, strict=False)
    missing = [k for k in missing if k != "latent_pool.latents"]
    if missing or unknown:
        raise KeyError(f"state_dict does not fit the generator: missing {missing[:8]}, "
                       f"unknown {unknown[:8]}")
    return gen


def load_trainer_checkpoint(path: str, gen: torch.nn.Module):
    """The port's ``Trainer`` checkpoint (``utils/checkpoint.py``) into
    ``gen``: its G state_dict (buffers: BN running stats, spectral-norm
    ``u``), then the EMA parameters in place of the trained ones, as the
    trainer's samples run (``trainers/base_trainer.py::_ema_weights``)."""
    from threedhumangan_tpu_torch.utils.checkpoint import load_checkpoint

    payload = load_checkpoint(path)
    _fit_latent_pool(gen, payload["G"]["latent_pool.latents"])
    gen.load_state_dict(payload["G"])
    with torch.no_grad():
        for k, p in gen.named_parameters():
            p.copy_(payload["ema"]["params"][k])
    return gen
