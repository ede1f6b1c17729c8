"""The layer counts of ``perfbench.flops`` against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference at a
small configuration, and the bounds against ``chip_smoke.py``'s."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, harness
from perfbench.reference.generator import ReferenceGenerator
from perfbench.reference.weights import generator_leaves, make_state

from _small import small_config


def counted(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def small():
    meta = harness.step_meta(small_config(harness.Spec().cell("gen.map3dbn512l.b8").config))
    state = make_state(generator_leaves(meta), torch.Generator().manual_seed(3), "cpu")
    return meta, ReferenceGenerator(state, meta)


def test_field_products(small):
    meta, ref = small
    P = meta["render_width"] * meta["render_height"] * meta["num_steps"]
    H, NB = meta["hidden_dim"], meta["neural_field_blocks"]
    pts, geo = torch.rand(P, 3), torch.rand(P, meta["geo_feature_dim"])
    got = counted(ref.field, pts, geo, torch.rand(NB * H), torch.rand(NB * H))
    assert got == flops.field(meta, 1)["flops"]


def test_synthesis_products(small):
    """Per pixel exactly; the per-image parts (the SPADE MLP of the style
    row, the spectral norms) are left out of the count and are under 1%
    here."""
    meta, ref = small
    px = meta["gen_height"] * meta["gen_width"]
    got = counted(ref.synthesis, torch.rand(px, meta["feature_dim"]),
                  torch.rand(1, meta["feature_dim"]))
    want = flops.synthesis(meta, 1)["flops"]
    assert want <= got <= 1.01 * want


def test_mapping_products(small):
    meta, ref = small
    assert counted(ref.mapping, torch.rand(5, meta["latent_dim"])) == flops.mapping(meta, 5)[
        "flops"]


def test_discriminator_products():
    """Every conv exactly; the spectral norms' products are left out and
    are under 1% here."""
    from perfbench.reference.discriminator import ReferenceDiscriminator, discriminator_leaves
    from perfbench.reference.training import split_state

    meta = harness.step_meta(small_config(harness.Spec().cell("train.map3dbn.b32").config))
    params, u = split_state(make_state(discriminator_leaves(meta), torch.Generator().manual_seed(4),
                                       "cpu"))
    D = ReferenceDiscriminator(params, u, meta)
    with torch.no_grad():
        got = counted(D.forward, torch.rand(2, meta["gen_height"], meta["gen_width"], 3), False)
    want = flops.discriminator(meta, 2)["flops"]
    assert want <= got <= 1.01 * want


def test_training_pair_counts():
    meta = harness.step_meta(harness.Spec().cell("train.map3dbn.b32").config)
    t = flops.training(meta, 32)
    g = sum(flops.generation(dict(meta, use_mixed_precision=True), 32)[k]["flops"]
            for k in ("field", "synthesis", "mapping"))
    d = flops.discriminator(meta, 32)["flops"]
    assert t["fakes"]["flops"] == g
    assert t["g_backward"]["flops"] == 2 * g + d
    assert t["pair"]["flops"] == 4 * g + 8 * d and t["pair_r1"]["flops"] == 4 * g + 12 * d


def test_bounds_equal_chip_smoke():
    import chip_smoke

    meta = harness.step_meta(harness.Spec().cell("gen.map3dbn512l.b8").config)
    B, R, S = 8, meta["render_width"] * meta["render_height"], meta["num_steps"]
    packed = torch.empty(B, R * S, 38, dtype=torch.bfloat16, device="meta")
    out = torch.empty(B, R, meta["feature_dim"] + 3, device="meta")
    f = flops.field(meta, B)
    assert math.isclose(chip_smoke.field_bound(packed, out, meta, 0)["bound_ms"],
                        flops.bound_s(f["flops"], f["bytes"]) * 1e3, rel_tol=1e-12)
    style = torch.empty(B, meta["gen_height"], meta["gen_width"], meta["feature_dim"],
                        dtype=torch.bfloat16, device="meta")
    rgb = torch.empty(B, meta["gen_height"], meta["gen_width"], 3, device="meta")
    s = flops.synthesis(meta, B)
    assert math.isclose(chip_smoke.synthesis_bound(meta, style, rgb)["bound_ms"],
                        flops.bound_s(s["flops"], s["bytes"]) * 1e3, rel_tol=1e-12)
    assert flops.PEAK_BF16 == chip_smoke.PEAK_BF16 and flops.HBM_BPS == chip_smoke.HBM_BPS
