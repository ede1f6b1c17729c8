"""K8's and K9's packed weight stream (threedhumangan_tpu_torch/ops/
raymarch_bwd.py::pack_field_bwd_stream), on the CPU: every weight is read
back through a mirror of the kernels' addressing (csrc/raymarch_bwd.cu's
producer walks, synthesis_core.cuh's B descriptor) and compared bit for bit
with the padded bf16 tables of ``kernel_tables`` (the forward half) and
their transposes (the backward half); the side tables equal
``kernel_tables``' values; the chunk count, sizes, alignment and stage
capacity are what the producers and the C entries expect; the wrappers'
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
from threedhumangan_tpu_torch.utils.misc import pad_to

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
    t, _ = rm.kernel_tables(w, freq_k, phase_k)
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
    t, _ = rm.kernel_tables(w, freq_k, phase_k)
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
