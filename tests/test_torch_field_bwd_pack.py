"""The packed weight stream of K4, K5, K8 and K9 (threedhumangan_tpu_torch/
ops/raymarch_bwd.py::pack_field_bwd_stream), on the CPU: every weight is read
back through a mirror of the kernels' addressing (csrc/raymarch_bwd.cu's
producer walks, synthesis_core.cuh's B descriptor) and compared bit for bit
with the padded bf16 tables of the field's weights (``kernel_tables``,
the forward half) and their transposes (the backward half); the side
tables equal ``kernel_tables``' values; the chunk count, sizes, alignment and stage
capacity are what the producers and the C entries expect; the forward
half, which K4, K5 and K8 read, is packed alone; the shared memory of
csrc/field_core.cuh's layout fits at every shipped width; the wrappers'
operands come in the C order; widths above the kernels' cap raise.  No JAX
here: the kernels' math is held against the JAX package through their
plain versions (tests/test_torch_field_bwd.py) and on the card
(chip_smoke.py)."""

import ctypes

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
from threedhumangan_tpu_torch.utils.misc import pad_to, round16

B, G = 2, 31
MAX_SMEM = 232448  # the shared memory a CTA may have (csrc/raymarch_bwd.cu)


def _case(hidden, nb, seed=0):
    field = CoordConcatSiren(3, hidden, G, hidden, nb,
                             generator=torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    freq = torch.as_tensor(0.3 * rs.randn(B, nb * hidden).astype(np.float32))
    phase = torch.as_tensor(0.3 * rs.randn(B, nb * hidden).astype(np.float32))
    w = rm.flat_weights(field)
    freq_k, phase_k = rm.film_tables(freq, phase, nb)
    return w, freq_k, phase_k


def kernel_tables(w, freq_k, phase_k):
    """The reference layout: zero-padded bf16/f32 tables of the field's own
    weights (widths rounded up to 16, the first layers block-diagonal, omega
    not folded) and the per-image freq/phase tables, as matrices."""
    bf16, f32 = torch.bfloat16, torch.float32
    H = w["w_coord"].shape[1]
    G = w["w_geo"].shape[0]
    F = w["w_feat"].shape[1]
    B, NB, _ = freq_k.shape
    n_in = 3 + G
    k0p, n0p, hp, headp = round16(n_in), round16(2 * H), round16(H), round16(F + 3)
    first = w["w_coord"].new_zeros(n_in, 2 * H)
    first[:3, :H] = w["w_coord"]
    first[3:, H:] = w["w_geo"]
    stk = (torch.stack([w[f"w_net{i}"] for i in range(1, NB)], 0) if NB > 1
           else w["w_coord"].new_zeros(1, H, H))
    head = torch.cat([w["w_rgb"], w["w_feat"]], 1)
    t = dict(
        w_first=pad_to(first, (k0p, n0p), bf16),
        b_first=pad_to(torch.cat([w["b_coord"], w["b_geo"]]), (n0p,), f32),
        w_net0=pad_to(w["w_net0"], (n0p, hp), bf16),
        w_net_stk=pad_to(stk, (max(NB - 1, 1), hp, hp), bf16),
        b_net=pad_to(torch.stack([w[f"b_net{i}"] for i in range(NB)], 0), (NB, hp), f32),
        freq=pad_to(freq_k, (B, NB, hp), f32),
        phase=pad_to(phase_k, (B, NB, hp), f32),
        w_color_x=pad_to(w["w_color"][3:], (hp, hp), bf16),
        w_color_d=pad_to(w["w_color"][:3].to(bf16), (3, hp), f32),
        b_color=pad_to(w["b_color"], (hp,), f32),
        w_sigma=pad_to(w["w_sigma"][:, 0].to(bf16), (hp,), f32),
        b_sigma=w["b_sigma"].reshape(1).float().contiguous(),
        w_head=pad_to(head, (hp, headp), bf16),
        b_head=pad_to(torch.cat([w["b_rgb"], w["b_feat"]]), (headp,), f32),
    )
    return t, dict(H=H, F=F, NB=NB, n_in=n_in, k0p=k0p, n0p=n0p, hp=hp, headp=headp)


class KernelReader:
    """The kernels' view of the stream: the producer's chunk walk (a chunk
    starts where the last one ended) and, inside a chunk image, the byte
    that wgmma's B descriptor addresses for (k, n): core matrix (n // 8,
    k // 8) at 256 bytes a column group and 128 a K half, row n % 8,
    element k % 8."""

    def __init__(self, words, sizes):
        self.words = words
        self.sizes = sizes
        self.pos = 0  # bytes
        self.chunk = 0

    def product(self, K, N):
        k = np.arange(16)[:, None]
        n = np.arange(N)[None, :]
        byte = (n // 8) * 256 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
        out = np.empty((K, N), np.int16)
        for q in range(K // 16):
            assert self.sizes[self.chunk] == 16 * N * 2
            assert self.pos % 16 == 0
            out[16 * q:16 * q + 16] = self.words[(self.pos + byte) // 2]
            self.pos += self.sizes[self.chunk]
            self.chunk += 1
        return out


def _bits(t):
    return t.to(torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("hidden", [32, 384, 420])
def test_stream_reads_back_every_weight_bit_for_bit(hidden, nb):
    """In the producers' order: the forward half (K8's whole walk) against
    ``kernel_tables``, w_sigma in the colour product's column H; then the
    backward half against the transposes."""
    w, freq_k, phase_k = _case(hidden, nb)
    t, _ = kernel_tables(w, freq_k, phase_k)
    d = rb.field_bwd_dims(w, nb)
    k0p, n0p, hp, nc, headp = d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"]
    stream, sizes = rb.pack_field_bwd_stream(w, d)
    assert stream.dtype == torch.bfloat16 and stream.shape == (sum(sizes) // 2,)
    rd = KernelReader(stream.view(torch.int16).numpy(), sizes)
    eq = np.testing.assert_array_equal
    eq(np.concatenate([rd.product(k0p, n) for n in d["first"]], 1), _bits(t["w_first"]))
    eq(rd.product(n0p, hp), _bits(t["w_net0"]))
    for i in range(nb - 1):
        eq(rd.product(hp, hp), _bits(t["w_net_stk"][i]))
    color = rd.product(hp, nc)
    eq(color[:, :hidden], _bits(t["w_color_x"][:, :hidden]))
    eq(color[:, hidden], _bits(t["w_sigma"]))
    assert not color[:, hidden + 1:].any() and not color[hidden:].any()
    eq(rd.product(hp, headp), _bits(t["w_head"]))
    assert rd.pos == d["fwd_bytes"]
    # backward half: the transposes, the trunk's last block first
    eq(rd.product(headp, hp), _bits(t["w_head"].t()))
    eq(rd.product(hp, hp), _bits(t["w_color_x"].t()))
    for i in range(nb - 2, -1, -1):
        eq(rd.product(hp, hp), _bits(t["w_net_stk"][i].t()))
    eq(np.concatenate([rd.product(hp, n) for n in d["first"]], 1), _bits(t["w_net0"].t()))
    assert rd.chunk == len(sizes) and rd.pos == sum(sizes) == d["fwd_bytes"] + d["bwd_bytes"]


def _walk(d, bwd):
    """The chunks a producer copies, as (bytes copied, bytes the source
    advances): csrc/raymarch_bwd.cu::produce.  K9 copies only the first
    two column groups (16 columns: rgb) of each head chunk."""
    k0p, n0p, hp, nc, headp, nb = (d[k] for k in ("k0p", "n0p", "hp", "nc", "headp", "NB"))
    c = lambda n: 16 * n * 2
    walk = []
    for n in d["first"]:
        walk += [(c(n), c(n))] * (k0p // 16)
    walk += [(c(hp), c(hp))] * (n0p // 16 + (nb - 1) * hp // 16)
    walk += [(c(nc), c(nc))] * (hp // 16)
    walk += [(512 if bwd else c(headp), c(headp))] * (hp // 16)
    if bwd:
        walk += [(c(hp), c(hp))] * (headp // 16 + nb * hp // 16)
        for n in d["first"]:
            walk += [(c(n), c(n))] * (hp // 16)
    return walk


def _smem(d, stages):
    """csrc/raymarch_bwd.cu::field_bwd_smem: the ring, its mbarriers, the
    64 x max(n0p, headp) tile, the 64 x max(hp, k0p) tile and the floats."""
    ld = lambda n: n + 8
    return (stages * 16 * 2 * max(d["first"] + [d["hp"], d["nc"], d["headp"]])
            + 2 * stages * 8 + 2 * 64 * (ld(max(d["n0p"], d["headp"])) + ld(max(d["hp"], d["k0p"])))
            + 4 * 12 * 64)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("hidden", [32, 384, 420])
def test_stream_chunk_count_sizes_alignment_and_stage(hidden, nb):
    w, _, _ = _case(hidden, nb, seed=2)
    d = rb.field_bwd_dims(w, nb)
    stream, sizes = rb.pack_field_bwd_stream(w, d)
    k8, k9 = _walk(d, False), _walk(d, True)
    # the chunks are K8's walk, then the backward half; K9 walks them all
    assert sizes == [adv for _, adv in k8] + [adv for _, adv in k9[len(k8):]]
    assert [adv for _, adv in k9] == sizes
    assert sum(sizes[:len(k8)]) == d["fwd_bytes"] and sum(sizes) == stream.numel() * 2
    # every chunk starts 256-byte aligned (the bulk copy needs 16) and fits
    # a ring stage (the widest chunk); every product within 54 n8 tiles
    offsets = np.cumsum([0] + sizes[:-1])
    stage = max(sizes)
    assert all(s % 256 == 0 for s in sizes) and all(o % 256 == 0 for o in offsets)
    assert all(cp <= stage and cp % 16 == 0 for cp, _ in k9)
    assert stage <= 16 * 2 * rb.MAX_FIELD_WIDTH
    assert all(n % 8 == 0 and n <= rb.MAX_FIELD_WIDTH
               for n in d["first"] + [d["hp"], d["nc"], d["headp"]])
    assert sum(d["first"]) == d["n0p"] and max(d["first"]) - min(d["first"]) <= 8
    # four ring stages fit a CTA at every width up to the cap
    assert _smem(d, 4) <= MAX_SMEM


@pytest.mark.parametrize("hidden", [32, 40, 384])
def test_side_tables_equal_kernel_tables(hidden):
    nb = 4
    w, freq_k, phase_k = _case(hidden, nb, seed=1)
    t, _ = kernel_tables(w, freq_k, phase_k)
    d = rb.field_bwd_dims(w, nb)
    b_first, b_net, freq, phase, w_cd, w_sig, b_color, b_sigma, b_head = (
        rb.field_bwd_side_tables(w, freq_k, phase_k, d))
    eq = lambda got, ref: np.testing.assert_array_equal(
        got.numpy(), pad_to(ref, got.shape, torch.float32).numpy())
    eq(b_first, t["b_first"])
    eq(b_net, t["b_net"])
    assert freq.shape == phase.shape == (B, nb, d["nc"])
    eq(freq, t["freq"])
    eq(phase, t["phase"])
    eq(w_cd, t["w_color_d"])
    eq(w_sig, t["w_sigma"])
    eq(b_color, t["b_color"])
    eq(b_sigma, t["b_sigma"])
    eq(b_head, t["b_head"])


def test_stream_bytes_are_what_the_c_entries_check():
    """thgt_field_stats and thgt_field_bwd refuse a stream whose byte count
    is not what their producers walk: the forward half, and both halves."""
    hidden, nb = 40, 3
    w, _, _ = _case(hidden, nb, seed=3)
    d = rb.field_bwd_dims(w, nb)
    k0p, n0p, hp, nc, headp = d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"]
    fwd = 2 * (k0p * n0p + n0p * hp + (nb - 1) * hp * hp + hp * nc + hp * headp)
    bwd = 2 * (headp * hp + nb * hp * hp + hp * n0p)
    stream, sizes = rb.pack_field_bwd_stream(w, d)
    assert (d["fwd_bytes"], d["bwd_bytes"]) == (fwd, bwd)
    assert stream.numel() * 2 == fwd + bwd and stream.data_ptr() % 16 == 0


def test_widths_above_the_cap_raise():
    """hidden 440 pads to 448 > 432 columns: a ValueError before any launch."""
    w, freq_k, phase_k = _case(440, 2)
    with pytest.raises(ValueError, match="at most 432"):
        rb.field_bwd_dims(w, 2)
    packed = torch.zeros(B, 64, 3 + G + 3)
    g_out = torch.zeros(B, 4, 443)
    with pytest.raises(ValueError, match="at most 432"):
        rb.field_stats_cuda(w, packed, freq_k, phase_k, g_out, 16)


@pytest.mark.parametrize("noise", [False, True])
def test_operands_come_in_the_c_order(noise):
    """``field_stats_operands`` and ``field_bwd_step_operands`` hand the C
    entries their pointers in the order of ``_build.SIGNATURES``: the inputs,
    the stream (K8: its forward half), the side tables, the outputs; and
    the ints the C entries check."""
    hidden, nb, R, S = 40, 3, 8, 16
    w, fk, pk_ = _case(hidden, nb, seed=4)
    rs = np.random.RandomState(4)
    P, n_cols = R * S, 3 + G + 3 + noise
    packed = torch.as_tensor(rs.randn(B, P, n_cols).astype(np.float32))
    g_out = torch.as_tensor(rs.randn(B, R, hidden + 3).astype(np.float32))
    coef = torch.as_tensor(rs.rand(B, R, S).astype(np.float32))
    dsig = torch.as_tensor(rs.rand(B, R, S).astype(np.float32))
    d = rb.field_bwd_dims(w, nb)
    stream, _ = rb.pack_field_bwd_stream(w, d)
    tabs = rb.field_bwd_side_tables(w, fk, pk_, d)
    ints = [B, P, S, n_cols, 3 + G, hidden, d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"], nb,
            hidden + 3, 0]
    n_ptr = lambda name: _build.SIGNATURES[name].count(ctypes.c_void_p) - 1  # less the stream
    op = rb.field_stats_operands(w, packed, fk, pk_, g_out, S)
    ops = op["ops"]
    assert len(ops) == n_ptr("thgt_field_stats") == 14
    assert torch.equal(ops[0], packed.to(torch.bfloat16)) and torch.equal(ops[1], g_out)
    assert torch.equal(ops[2], stream[:d["fwd_bytes"] // 2])
    assert op["stream_bytes"] == d["fwd_bytes"]
    for got, ref in zip(ops[3:12], tabs):
        assert torch.equal(got, ref)
    assert ops[12].shape == ops[13].shape == (B, P) and op["ints"] == ints
    op = rb.field_bwd_step_operands(w, packed, fk, pk_, g_out, coef, dsig, S)
    b1, bufs = rb._group(op, 0)
    assert b1 == B and len(op["ins"]) + 1 + len(op["tabs"]) + len(bufs) == n_ptr("thgt_field_bwd")
    assert torch.equal(op["stream"], stream) and list(bufs) == list(rb._SAVED_ORDER)
    assert torch.equal(op["ins"][2], coef.reshape(B, P)) and torch.equal(op["ins"][3], dsig.reshape(B, P))
    rows, hp = B * P, d["hp"]
    assert bufs["xcol"].shape == bufs["dcol"].shape == (rows, hp + 16)
    assert bufs["dv"].shape == bufs["V"].shape == (nb, rows, hp)
    assert bufs["part"].shape == (rows // 64, rb.SUM_SLOTS, d["n0p"] + 3 * hp * (nb + 1))
    assert bufs["hsum"].shape == (rows // 64, d["headp"] + 1)


@pytest.mark.parametrize("nb", [1, 3, 4])
def test_forward_half_is_what_k4_reads(nb):
    """At hidden 420 (the generation width, hp = nc = headp = 432): the
    forward-only pack is the first ``fwd_bytes`` of the whole stream, its
    chunks are K4's and K5's walk (K8's), and it reads back the padded
    tables, w_sigma in the colour product's column H."""
    hidden = 420
    w, freq_k, phase_k = _case(hidden, nb, seed=5)
    t, _ = kernel_tables(w, freq_k, phase_k)
    d = rb.field_bwd_dims(w, nb)
    assert (d["hp"], d["nc"], d["headp"], d["n0p"]) == (432, 432, 432, 848)
    full, _ = rb.pack_field_bwd_stream(w, d)
    fwd, sizes = rb.pack_field_bwd_stream(w, d, forward_only=True)
    assert torch.equal(fwd, full[:d["fwd_bytes"] // 2])
    assert sizes == [adv for _, adv in _walk(d, False)] and sum(sizes) == d["fwd_bytes"]
    rd = KernelReader(fwd.view(torch.int16).numpy(), sizes)
    eq = np.testing.assert_array_equal
    eq(np.concatenate([rd.product(d["k0p"], n) for n in d["first"]], 1), _bits(t["w_first"]))
    eq(rd.product(d["n0p"], d["hp"]), _bits(t["w_net0"]))
    for i in range(nb - 1):
        eq(rd.product(d["hp"], d["hp"]), _bits(t["w_net_stk"][i]))
    color = rd.product(d["hp"], d["nc"])
    eq(color[:, hidden], _bits(t["w_sigma"]))
    eq(rd.product(d["hp"], d["headp"]), _bits(t["w_head"]))
    assert rd.chunk == len(sizes) and rd.pos == d["fwd_bytes"]


@pytest.mark.parametrize("hidden", [32, 40, 200, 256, 384, 420])
def test_shared_memory_of_every_mode_fits(hidden):
    """csrc/field_core.cuh gives K4, K5, K8 and K9 one layout
    (``field_smem``), within a CTA's 232,448 bytes at every shipped width
    (256, 384, 420) and the narrow widths of chip_smoke.py; K4's and K5's
    composite keeps one slot of head sums per (warp, ray) in the smaller
    activation tile at every step count it takes; K5 stages at least one
    vertex a chunk, and all 6,890 in one chunk at 384 and 420."""
    w, _, _ = _case(hidden, 4, seed=6)
    d = rb.field_bwd_dims(w, 4)
    ld = lambda n: n + 8
    assert _smem(d, 4) <= MAX_SMEM
    small_tile = 2 * 64 * ld(max(d["hp"], d["k0p"]))
    for S in (4, 8, 16, 32, 64):
        assert (64 // min(S, 16)) * d["headp"] * 4 <= small_tile
    vertices = 2 * 64 * (ld(max(d["n0p"], d["headp"])) + ld(max(d["hp"], d["k0p"]))) // 16
    assert vertices >= 1
    if hidden >= 384:
        assert vertices >= 6890


def _render_case(noise, seed=7, R=8, S=16):
    hidden, nb = 40, 3
    w, fk, pk = _case(hidden, nb, seed=seed)
    rs = np.random.RandomState(seed)
    f32 = lambda *shape: torch.as_tensor(rs.randn(*shape).astype(np.float32))
    return w, fk, pk, f32(B, R * S, 3 + G + 3 + noise), torch.as_tensor(
        np.sort(rs.rand(B, R, S), -1).astype(np.float32)), R, S


@pytest.mark.parametrize("noise", [False, True])
def test_unfolded_operands_come_in_the_c_order(noise):
    """``field_render_unfolded_operands`` hands ``thgt_raymarch_unfolded`` the
    float32 rows and z, the forward half of the stream with K8's side
    tables, the outputs, then K8's ints with white_back and last_back."""
    w, fk, pk, packed, z, R, S = _render_case(noise)
    P, n_cols = R * S, packed.shape[-1]
    op = rm.field_render_unfolded_operands(w, packed, fk, pk, z, S, white_back=True,
                                           exact_sin=True)
    d = rb.field_bwd_dims(w, 3)
    fwd, _ = rb.pack_field_bwd_stream(w, d, forward_only=True)
    ops = op["ops"]
    n_ptr = _build.SIGNATURES["thgt_raymarch_unfolded"].count(ctypes.c_void_p) - 1  # less the stream
    assert len(ops) == n_ptr == 14
    assert ops[0].dtype == torch.float32 and torch.equal(ops[0], packed) and torch.equal(ops[1], z)
    assert torch.equal(ops[2], fwd) and op["stream_bytes"] == d["fwd_bytes"]
    for got, ref in zip(ops[3:12], rb.field_bwd_side_tables(w, fk, pk, d)):
        assert torch.equal(got, ref)
    assert ops[12] is op["out"] and ops[13] is op["depth"]
    assert op["out"].shape == (B, R, 43) and op["depth"].shape == (B, R, 1)
    assert op["ints"] == [B, P, S, n_cols, 3 + G, 40, d["k0p"], d["n0p"], d["hp"], d["nc"],
                          d["headp"], 3, 43, 1, 1, 0]
    assert len(op["ints"]) == _build.SIGNATURES["thgt_raymarch_unfolded"].count(ctypes.c_int)


@pytest.mark.parametrize("legacy,noise,index", [(False, False, True), (True, True, False),
                                                (True, False, True)])
def test_geo_operands_come_in_the_c_order(legacy, noise, index):
    """``field_render_geo_operands`` hands ``thgt_raymarch_geo`` the raw rows,
    z, the posed vertices, their feature rows and the joints, the index
    output (or None), K4's weight operands and outputs, K4's ints with V, J
    and the legacy flag, then the input scale."""
    w, fk, pk, _, z, R, S = _render_case(noise, seed=8)
    rs = np.random.RandomState(8)
    f32 = lambda *shape: torch.as_tensor(rs.randn(*shape).astype(np.float32))
    V, J = 50, 24
    raw, verts, vfeat, skel = f32(B, R * S, 6 + noise), f32(B, V, 3), f32(B, V, 19), f32(B, J, 3)
    op = rm.field_render_geo_operands(w, raw, fk, pk, z, verts, vfeat, skel, S, 0.7,
                                      last_back=True, legacy_mode=legacy, return_index=index)
    d = rb.field_bwd_dims(w, 3)
    fwd, _ = rb.pack_field_bwd_stream(w, d, forward_only=True)
    sig = _build.SIGNATURES["thgt_raymarch_geo"]
    assert len(op["ops"]) + 1 + len(op["tabs"]) == sig.count(ctypes.c_void_p) - 1 == 18
    for got, ref in zip(op["ops"], (raw, z, verts, vfeat, skel)):
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert (op["idx"] is not None) == index
    if index:
        assert op["idx"].shape == (B, R * S) and op["idx"].dtype == torch.int32
    assert torch.equal(op["tabs"][0], fwd) and op["stream_bytes"] == d["fwd_bytes"]
    for got, ref in zip(op["tabs"][1:10], rb.field_bwd_side_tables(w, fk, pk, d)):
        assert torch.equal(got, ref)
    assert op["tabs"][10] is op["out"] and op["tabs"][11] is op["depth"]
    assert op["ints"] == [B, R * S, S, 6 + noise, 3 + G, 40, d["k0p"], d["n0p"], d["hp"], d["nc"],
                          d["headp"], 3, 43, 0, 0, 1, V, J, int(legacy)]
    assert len(op["ints"]) == sig.count(ctypes.c_int) and op["scaler"] == 0.7


def test_render_kernels_refuse_fewer_than_four_steps():
    """K4's and K5's composite takes whole rays of 4 to 64 steps a CTA: 2
    steps raise before any launch."""
    w, fk, pk, packed, _, _, _ = _render_case(False, seed=9)
    z = torch.rand(B, 64, 2)
    with pytest.raises(ValueError, match="num_steps"):
        rm.field_render_unfolded_operands(w, packed[:, :128], fk, pk, z, 2)
