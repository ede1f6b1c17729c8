"""Seeded weights of the Map3D generator, made on the device in two draws.

``generator_leaves(meta)`` lists every leaf of the generator's state dict
(the model's torch key space) with its shape and its init: the pi-GAN
SIREN init, torch's conv default, the equalised-lr normals of the style
mapping, spectral-norm ``u`` as a unit vector.  Beyond a fresh model, the
field's density bias is 0.5 (so that a body renders: at these random
weights every density otherwise sits below the clamp) and each batch norm
gets random affine and running stats (so that the eval normalisation does
work).  ``make_state`` draws all uniform leaves in one ``torch.rand`` and all
normal leaves in one ``torch.randn`` from a generator on ``device`` and
slices them; the benchmark loads the same state into the program and into
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]  # key, shape, kind, scale


def _linear(key, n_in, n_out, w_kind, w_scale, b_scale, conv=False) -> List[Leaf]:
    shape = (n_out, n_in, 1, 1) if conv else (n_out, n_in)
    return [(key + ".weight", shape, w_kind, w_scale), (key + ".bias", (n_out,), "uniform",
                                                          b_scale)]


def generator_leaves(meta: Dict) -> List[Leaf]:
    """(key, shape, kind, scale): kind 'uniform' (+-scale), 'normal' (std
    scale), 'unit' (a normal vector over its norm), 'const' (scale), with
    'bn_*' kinds for the random batch-norm state."""
    L, H, Fd = meta["latent_dim"], meta["hidden_dim"], meta["feature_dim"]
    NB_f, G = meta["neural_field_blocks"], meta["geo_feature_dim"]
    leaves: List[Leaf] = []
    f25 = lambda n: math.sqrt(6.0 / n) / 25.0
    nf = "neural_field."
    leaves += _linear(nf + "first_layer_coord.layer", meta["input_dim"], H, "uniform",
                      1.0 / meta["input_dim"], 1.0 / math.sqrt(meta["input_dim"]))
    leaves += _linear(nf + "first_layer_mod.layer", G, H, "uniform", 1.0 / G,
                      1.0 / math.sqrt(G))
    for i in range(NB_f):
        n_in = 2 * H if i == 0 else H
        leaves += _linear(f"{nf}network.{i}.layer", n_in, H, "uniform", f25(n_in),
                          1.0 / math.sqrt(n_in))
    leaves += [(nf + "sigma_layer.weight", (1, H), "uniform", f25(H)),
               (nf + "sigma_layer.bias", (1,), "const", 0.5)]
    leaves += _linear(nf + "color_layer_sine.layer", H + 3, H, "uniform", f25(H + 3),
                      1.0 / math.sqrt(H + 3))
    leaves += _linear(nf + "color_layer_linear", H, 3, "uniform", f25(H), 1.0 / math.sqrt(H))
    leaves += _linear(nf + "feature_layer_linear", H, Fd, "uniform", f25(H), 1.0 / math.sqrt(H))

    if meta.get("2d_semantic_input", False) or meta.get("2d_label_input", False):
        raise ValueError("the benchmark's weights take coordinates alone as synthesis input")
    leaves += _linear("synthesis_input.network.0", 2, Fd, "uniform", math.sqrt(9.0 / 2),
                      1.0 / math.sqrt(2), conv=True)
    style_in = 1 if "segments" in meta["condition_modal_gen"] else 3
    leaves += _linear("synthesis_style_input.from_coords.0", style_in, L, "uniform",
                      math.sqrt(9.0 / style_in), 1.0 / math.sqrt(style_in), conv=True)
    leaves += _linear("synthesis_style_input.network.0", 2 * L, Fd, "normal",
                      math.sqrt(2.0 / 1.04) / math.sqrt(2 * L), 1.0 / math.sqrt(2 * L), conv=True)
    leaves += _linear("synthesis_style_input.network.2", Fd, Fd, "normal",
                      math.sqrt(2.0 / 1.04) / math.sqrt(Fd), 1.0 / math.sqrt(Fd), conv=True)

    if meta.get("spatial_normalization", "batch_norm") != "batch_norm":
        raise ValueError("the benchmark's weights take batch-norm SPADE blocks")
    n_in = Fd
    for i in range(meta["synthesis_blocks"]):
        key = f"synthesis_network.network.m3d_{i}"
        for c, (ci, co) in enumerate(((n_in, H), (H, H))):
            s = 1.0 / math.sqrt(ci)
            leaves += [(f"{key}.conv_{c}.weight_orig", (co, ci, 1, 1), "uniform", s),
                       (f"{key}.conv_{c}.bias", (co,), "uniform", s),
                       (f"{key}.conv_{c}.weight_u", (co,), "unit", 1.0)]
        for c, ci in enumerate((n_in, H)):
            sp = f"{key}.spade_{c}"
            leaves += [(sp + ".first_norm.weight", (ci,), "bn_weight", 0.1),
                       (sp + ".first_norm.bias", (ci,), "normal", 0.1),
                       (sp + ".first_norm.running_mean", (ci,), "normal", 0.1),
                       (sp + ".first_norm.running_var", (ci,), "bn_var", 0.25),
                       (sp + ".first_norm.num_batches_tracked", (), "const", 0.0)]
            leaves += _linear(sp + ".mlp_shared.0", Fd, 128, "uniform", 1.0 / math.sqrt(Fd),
                              1.0 / math.sqrt(Fd), conv=True)
            for head in ("mlp_gamma", "mlp_beta"):
                leaves += _linear(f"{sp}.{head}", 128, ci, "uniform", 1.0 / math.sqrt(128),
                                  1.0 / math.sqrt(128), conv=True)
        leaves += _linear(f"synthesis_network.to_rgbs.m3d_{i}.linear", H, 3, "uniform",
                          0.25 / math.sqrt(H), 1.0 / math.sqrt(H), conv=True)
        n_in = H

    mp = "neural_field_mapping_network.network."
    dims = [L, H, H, H, 2 * NB_f * H]
    for i in range(4):
        std = math.sqrt(2.0 / 1.04) / math.sqrt(dims[i]) * (0.25 if i == 3 else 1.0)
        leaves += _linear(f"{mp}{2 * i}", dims[i], dims[i + 1], "normal", std,
                          1.0 / math.sqrt(dims[i]))
    sm = "synthesis_mapping_network."
    fc = lambda key, n_in, n_out: [(key + ".weight", (n_out, n_in), "normal", 100.0),
                                   (key + ".bias", (n_out,), "const", 0.0)]
    for i in range(7):
        leaves += fc(f"{sm}trunk{i}", L if i == 0 else Fd, Fd)
    leaves += fc(sm + "implicit0", Fd, 1) + fc(sm + "superres0", Fd, Fd)
    leaves.append(("latent_pool.latents", (meta["dataset_length"], L), "const", 0.0))
    return leaves


def make_state(leaves: List[Leaf], generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The leaves' values: one uniform and one normal draw on ``device``."""
    n_of = lambda shape: math.prod(shape)
    n_u = sum(n_of(s) for _, s, k, _ in leaves if k in ("uniform", "bn_var"))
    n_n = sum(n_of(s) for _, s, k, _ in leaves if k in ("normal", "unit", "bn_weight"))
    u = torch.rand(n_u, generator=generator, device=device) * 2.0 - 1.0
    n = torch.randn(n_n, generator=generator, device=device)
    state, iu, i_n = {}, 0, 0
    for key, shape, kind, scale in leaves:
        k = n_of(shape)
        if kind in ("uniform", "bn_var"):
            t = u[iu:iu + k].reshape(shape)
            iu += k
            t = t * scale + (1.0 if kind == "bn_var" else 0.0)
        elif kind in ("normal", "unit", "bn_weight"):
            t = n[i_n:i_n + k].reshape(shape)
            i_n += k
            if kind == "unit":
                t = t / (torch.linalg.norm(t) + 1e-12)
            else:
                t = t * scale + (1.0 if kind == "bn_weight" else 0.0)
        elif key.endswith("num_batches_tracked"):
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            t = torch.full(shape, scale, device=device)
        state[key] = t.contiguous()
    return state
