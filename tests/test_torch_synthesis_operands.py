"""K3's cached weight operands (threedhumangan_tpu_torch/ops/synthesis_kernel.py::
synthesis_operands): built once per set of weights, kept on the network out
of every state dict, rebuilt on each change of a parameter or buffer, and
equal to a fresh fold.  On the CPU at MAP3DBN_NANO's widths through the eval
generator and K3's plain version; one test on a CUDA card holds the cached
launch bit-equal to the uncached one (``python -m pytest --noconftest -m card
tests/test_torch_synthesis_operands.py`` there)."""

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import SyntheticSHHQDataset, iterate_batches, to_tensors
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import synthesis_kernel as sk
from threedhumangan_tpu_torch.trainers.base_trainer import _ema_weights
from threedhumangan_tpu_torch.utils.ema import ema_init
from threedhumangan_tpu_torch.utils.misc import mm


def _meta():
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(nerf_noise=0, perturb_rays=False)
    return meta


def _generator(meta, seed):
    g = gen.init_generator(meta, torch.Generator().manual_seed(seed), "cpu")
    rs = np.random.RandomState(seed)
    with torch.no_grad():  # running stats away from (0, 1), so the fold has work to do
        for m in g.synthesis_network.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.as_tensor(rs.randn(m.num_features) * 0.3))
                m.running_var.copy_(torch.as_tensor(rs.uniform(0.5, 2.0, m.num_features)))
    return g


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(sk, "operand_builds", 0)
    monkeypatch.setattr(sk, "operand_hits", 0)
    return lambda: (sk.operand_builds, sk.operand_hits)


def test_two_eval_forwards_build_once_and_hit_once(counters, monkeypatch):
    """``generator_forward`` twice on the same weights: one build, one hit,
    and images ``torch.equal`` to a forward on a fresh fold every batch."""
    meta = _meta()
    g = _generator(meta, 0)
    batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(
        smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64), **meta), 2,
        shuffle=False)), "cpu")
    cond = get_preprocessor(meta)(batch, rotate=True, generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, meta["latent_dim"], generator=torch.Generator().manual_seed(2))
    run = lambda: gen.generator_forward(g, z, cond, meta, torch.Generator().manual_seed(3))
    outs = [run()["rgbs"] for _ in range(2)]
    assert counters() == (1, 1)
    monkeypatch.setattr(gen, "synthesis_operands", lambda net, inp, norm, *a: (
        sk.fold_synthesis_params(net, inp, norm), None))
    fresh = run()["rgbs"]
    assert counters() == (1, 1)
    for out in outs:
        assert torch.equal(out, fresh)


def _set_ema(g):
    ema = ema_init(g)
    for k, e in ema["params"].items():
        e.add_(0.05 * torch.randn(e.shape, generator=torch.Generator().manual_seed(len(k))))
    swap = _ema_weights(g, ema)
    swap.__enter__()
    yield "EMA in"
    swap.__exit__(None, None, None)
    yield "trained weights back"


def _load_state_dict(g):
    g.load_state_dict(_generator(_meta(), 7).state_dict())
    yield "other weights"


def _add_to_a_conv(g):
    with torch.no_grad():
        g.synthesis_network.network["m3d_1"].conv_0.weight_orig.add_(0.1)
    yield "in-place add_"


def _running_var(g):
    with torch.no_grad():
        g.synthesis_network.network["m3d_0"].spade_1.first_norm.running_var.mul_(1.5)
    yield "running var"


def _spectral_u(g):
    with torch.no_grad():
        g.synthesis_network.network["m3d_2"].conv_1.normalized_weight(train=True)
    yield "u's power iteration"


def _new_data(g):
    b = g.synthesis_network.to_rgbs["m3d_2"].linear.bias
    b.data = b.data.clone()
    yield "a new storage"
    with torch.no_grad():
        b.add_(0.5)
    yield "then a change"


def _to_and_back(g):
    g.to(torch.float64).to(torch.float32)
    yield ".to() twice"


INVALIDATIONS = {f.__name__.strip("_"): f for f in (
    _load_state_dict, _add_to_a_conv, _running_var, _set_ema, _spectral_u, _new_data,
    _to_and_back)}


@pytest.mark.parametrize("case", sorted(INVALIDATIONS))
def test_each_change_of_the_weights_rebuilds(case, counters):
    """After each change the next K3 call builds anew and equals K3 on a
    fresh fold; a call on unchanged weights hits."""
    meta = _meta()
    g = _generator(meta, 0)
    net, inp = g.synthesis_network, g.synthesis_input
    nb, mods, mode = meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["map3d_mode"]
    norm = net.spatial_normalization
    rs = np.random.RandomState(5)
    F = meta["feature_dim"]
    style = torch.as_tensor(rs.randn(2, 8, 4, F).astype(np.float32))
    fixed = torch.as_tensor(rs.randn(2, 1, F).astype(np.float32))

    def k3(folded, tables=None):
        return sk.fused_synthesis(folded, style, fixed, nb, mods, mode, torch.float32,
                                  tables=tables)

    cached = lambda: k3(*sk.synthesis_operands(net, inp, norm, nb, mods, mode))
    fresh = lambda: k3(sk.fold_synthesis_params(net, inp, norm))
    before = cached()
    assert counters() == (1, 0)
    builds = 1
    for step in INVALIDATIONS[case](g):
        got = cached()
        builds += 1
        assert counters() == (builds, 0), step
        assert torch.equal(got, fresh()), step
        assert torch.equal(cached(), got), step
        assert counters() == (builds, 1), step
        sk.operand_hits = 0
    if case not in ("set_ema", "to_and_back"):  # these end on the weights they started from
        assert not torch.equal(got, before)


def test_the_entry_is_no_state():
    """The cached operands are a plain attribute: in no state dict, buffer
    list or parameter list, and the names of each are what they were."""
    meta = _meta()
    g = _generator(meta, 0)
    net = g.synthesis_network
    names = lambda m: (sorted(m.state_dict()), [n for n, _ in m.named_buffers()],
                       [n for n, _ in m.named_parameters()])
    before = names(g), names(net)
    sk.synthesis_operands(net, g.synthesis_input, net.spatial_normalization,
                          meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["map3d_mode"])
    assert sk._ENTRY in vars(net)
    assert (names(g), names(net)) == before
    assert not any(sk._ENTRY in n for part in names(g) for n in part)


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_rank1_rows_round_as_each_product_did(cd):
    """``rank1_rows`` with its weights rounded once (made in the call or
    handed in from the cache) equals rounding both operands of every
    product, as ``utils.misc.mm`` does, bit for bit."""
    meta = _meta()
    g = _generator(meta, 0)
    folded = sk.fold_synthesis_params(g.synthesis_network, g.synthesis_input, "batch_norm")
    rank1 = [1, 2]
    fx = torch.randn(3, 1, meta["feature_dim"], generator=torch.Generator().manual_seed(4))
    mmr = lambda x, w: mm(x, w, cd).to(cd).float()
    rows = []
    for i in rank1:
        for si in (0, 1):
            k = f"b{i}_sp{si}"
            actv = torch.relu(mmr(fx.reshape(3, -1), folded[f"{k}_sh_w"])
                              + folded[f"{k}_sh_b"]).to(cd)
            rows += [mmr(actv, folded[f"{k}_g_w"]) + folded[f"{k}_g_b"],
                     mmr(actv, folded[f"{k}_bt_w"]) + folded[f"{k}_bt_b"]]
    want = torch.stack(rows, 1)
    assert torch.equal(sk.rank1_rows(folded, fx, rank1, cd), want)
    assert torch.equal(sk.rank1_rows(folded, fx, rank1, cd, sk.rank1_weights(folded, rank1, cd)),
                       want)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["isolated", "mixed", "all"])
def test_cached_launch_is_bit_equal_on_the_card(mode, counters, monkeypatch):
    """At MAP3DBN512L's widths (9 blocks, 420 wide) on the card: two K3
    launches through the cached operands give the images of
    ``synthesis_cuda`` given only a fresh fold, bit for bit, and the weight
    stream is packed once for both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 launches there only")
    meta = configs.extract_metadata(configs.MAP3DBN512L, 0)
    nb, mods, C = meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["hidden_dim"]
    dev = torch.device("cuda")
    gen_ = torch.Generator().manual_seed(11)
    net = syn.SynthesisNetwork(C, C, C, nb, mods, "batch_norm", mode)
    inp = syn.SynthesisInput(2, C)
    net.reset_parameters(gen_)
    inp.reset_parameters(gen_)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(C, generator=gen_))
                m.running_var.copy_(0.5 + torch.rand(C, generator=gen_) * 1.5)
    net, inp = net.to(dev).eval(), inp.to(dev).eval()
    style = torch.randn(2, 64, 32, C, generator=gen_).to(dev, torch.bfloat16)
    fixed = torch.randn(2, 1, C, generator=gen_).to(dev, torch.bfloat16)
    packs = []
    pack = sk.pack_weight_stream
    monkeypatch.setattr(sk, "pack_weight_stream", lambda *a: packs.append(1) or pack(*a))
    outs = []
    for _ in range(2):
        folded, tables = sk.synthesis_operands(net, inp, "batch_norm", nb, mods, mode)
        outs.append(sk.fused_synthesis(folded, style, fixed, nb, mods, mode, tables=tables))
    assert counters() == (1, 1) and len(packs) == 1
    ref = sk.synthesis_cuda(sk.fold_synthesis_params(net, inp, "batch_norm"), style, fixed, nb,
                            mods, mode)
    torch.cuda.synchronize()
    assert len(packs) == 2
    assert torch.isfinite(ref).all() and float(ref.std()) > 0
    for out in outs:
        assert torch.equal(out, ref)
