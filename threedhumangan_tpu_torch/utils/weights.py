"""Move JAX generator weights into the port.

``from_jax_params(params, state)`` takes the JAX package's generator pytrees
(``init_generator`` / ``convert_generator_state_dict`` layout) as numpy
arrays and returns the port's ``state_dict`` — the reference torch key space,
so ``threedhumangan_tpu.utils.torch_convert.convert_generator_state_dict``
maps it straight back.  Layouts: JAX Linear / 1x1-conv weights are (in, out)
and become (out, in[, 1, 1]); the equalised-lr FC weights stay (out, in)
(their gains are recomputed from the shapes).  No JAX import: any array
with ``numpy.asarray`` support is accepted.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
