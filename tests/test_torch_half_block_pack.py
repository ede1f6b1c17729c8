"""K11's packed weight stream and its weight-gradient plan, on the CPU.

threedhumangan_tpu_torch/ops/synthesis_train.py::pack_bwd_stream lays every
weight K11's body reads out as one bf16 stream of chunk images; each product's
weights are read back here through a mirror of the kernel's addressing
(csrc/synthesis_train_bwd.cu, synthesis_core.cuh) and compared bit for bit
with the padded bf16 weights.  The chunk count, sizes and alignment are what
the producer lane and the C entry expect; the row chunks of the shared
weight-gradient reduction (ops/raymarch_bwd.py::wgrad_plan, csrc/wgrad.cu)
cover every row once.  No JAX here: the kernel's math is held against the JAX
package through its plain version (tests/test_torch_synthesis_train.py) and
on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
from threedhumangan_tpu_torch.ops import synthesis_train as st
from threedhumangan_tpu_torch.utils.misc import pad_to

HID = 128
STAGE_CAP = 16 * 432 * 2  # the bytes of a ring stage at the widest width K11 takes


def _case(ci, cs, spatial, with_fixed=False, co=None, H=5, W=30, seed=0):
    """Seeded weights and small inputs of one half-block (float32 weights,
    bf16 activations), as ``half_block_backward_cuda`` receives them."""
    co = ci if co is None else co
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)
    args = dict(h=rn(2, H, W, ci).bfloat16(), style=None, fixed=None, gam=None, bet=None,
                m=rn(ci), r=rn(ci).abs() + 0.5, a=rn(ci), b=rn(ci), mlp=None, w=rn(ci, co))
    if spatial:
        args["style"] = rn(2, H, W, cs).bfloat16()
        args["fixed"] = rn(2, cs) if with_fixed else None
        args["mlp"] = dict(sh_w=rn(cs, HID), sh_b=rn(HID), g_w=rn(HID, ci), g_b=rn(ci),
                           bt_w=rn(HID, ci), bt_b=rn(ci))
    else:
        args["gam"], args["bet"] = rn(2, ci).bfloat16(), rn(2, ci).bfloat16()
    return args, rn(2, H, W, co).bfloat16()


class KernelReader:
    """The kernel's view of the stream: the producer's chunk walk (a chunk
    starts where the last one ended) and, inside a chunk image, the byte
    that wgmma's B descriptor addresses for (k, n): core matrix (n // 8,
    k // 8) at 256 bytes a column group and 128 a K half, row n % 8,
    element k % 8."""

    def __init__(self, stream, sizes):
        self.words = stream.view(torch.int16).numpy()
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

    def gamma_beta(self, K, cip):
        """Both heads from their two column passes: chunk column n is unit
        n // 16, head (n // 8) % 2, output column pass * cip/2 + 8 unit + n % 8
        (the gamma/beta epilogue in csrc/synthesis_train_bwd.cu)."""
        h2 = cip // 2
        heads = np.zeros((2, K, cip), np.int16)
        n = np.arange(cip)
        for p in (0, 1):
            img = self.product(K, cip)
            heads[(n // 8) % 2, :, p * h2 + (n // 16) * 8 + n % 8] = img.T
        return heads


def _bits(t, shape):
    return pad_to(t, shape, torch.bfloat16).view(torch.int16).numpy()


def _dims(args):
    return st._dims(args["h"], args["style"], args["w"], args["mlp"])


@pytest.mark.parametrize("ci", [40, 384, 420])
@pytest.mark.parametrize("spatial", [True, False])
def test_stream_reads_back_every_weight_bit_for_bit(ci, spatial):
    """Ci 40 and 420 pad to 48 and 432: ragged unit runs over the kernel's
    3 consumer warpgroups; Cs 24 pads to 32."""
    args, _ = _case(ci, 24 if ci == 40 else ci, spatial)
    d = _dims(args)
    stream, sizes = st.pack_bwd_stream(args["w"], args["mlp"], d)
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    cip, cop, csp, hidp = d["cip"], d["cop"], d["csp"], d["hidp"]
    rd = KernelReader(stream, sizes)
    mlp = args["mlp"]
    if spatial:
        np.testing.assert_array_equal(rd.product(csp, hidp), _bits(mlp["sh_w"], (csp, hidp)))
        gam, bet = rd.gamma_beta(hidp, cip)
        np.testing.assert_array_equal(gam, _bits(mlp["g_w"], (hidp, cip)))
        np.testing.assert_array_equal(bet, _bits(mlp["bt_w"], (hidp, cip)))
    np.testing.assert_array_equal(rd.product(cop, cip), _bits(args["w"].t(), (cop, cip)))
    if spatial:
        gbT = torch.cat([pad_to(mlp["g_w"], (hidp, cip), torch.float32).t(),
                         pad_to(mlp["bt_w"], (hidp, cip), torch.float32).t()], 0)
        np.testing.assert_array_equal(rd.product(2 * cip, hidp), _bits(gbT, (2 * cip, hidp)))
        np.testing.assert_array_equal(rd.product(hidp, csp), _bits(mlp["sh_w"].t(), (hidp, csp)))
    assert rd.chunk == len(sizes) and rd.pos == stream.numel() * 2


@pytest.mark.parametrize("ci", [40, 384, 420])
@pytest.mark.parametrize("spatial", [True, False])
def test_stream_chunk_count_sizes_and_alignment(ci, spatial):
    args, _ = _case(ci, 24 if ci == 40 else ci, spatial, seed=3)
    d = _dims(args)
    cip, cop, csp, hidp = d["cip"], d["cop"], d["csp"], d["hidp"]
    stream, sizes = st.pack_bwd_stream(args["w"], args["mlp"], d)
    # the producer's walk (csrc/synthesis_train_bwd.cu::produce)
    want = []
    if spatial:
        want += [16 * hidp * 2] * (csp // 16) + [16 * cip * 2] * (2 * hidp // 16)
    want += [16 * cip * 2] * (cop // 16)
    if spatial:
        want += [16 * hidp * 2] * (2 * cip // 16) + [16 * csp * 2] * (hidp // 16)
    assert sizes == want
    # the C entry's byte count of the whole stream
    expect = 2 * cop * cip + (2 * (2 * csp * hidp + 4 * hidp * cip) if spatial else 0)
    assert stream.numel() * 2 == sum(sizes) == expect
    offsets = np.cumsum([0] + sizes[:-1])
    assert all(s % 256 == 0 and s <= STAGE_CAP for s in sizes)
    assert all(o % 128 == 0 for o in offsets)


@pytest.mark.parametrize("with_fixed", [True, False])
def test_operands_in_the_c_order(with_fixed):
    """``bwd_operands`` (plain PyTorch, so it runs here on CPU tensors): the
    pointer list of the C entry, its weight stream and its operand pairs; g
    itself is dW's operand only when the tiles cover the pixels exactly."""
    for H, W, ci, own_g in ((5, 30, 40, False), (4, 32, 48, True)):
        args, g = _case(ci, 24, True, with_fixed, H=H, W=W)
        op = st.bwd_operands(**args, g=g)
        d = op["d"]
        assert len(op["ptrs"]) == 23 and op["ints"][-1] == int(with_fixed)
        stream, _ = st.pack_bwd_stream(args["w"], args["mlp"], d)
        assert torch.equal(op["ptrs"][12], stream)
        assert op["stream_bytes"] == stream.numel() * 2
        assert (op["ptrs"][17] is None) == own_g
        rows = 2 * d["tiles"] * st.PIXELS_PER_CTA
        X, Y = op["prods"]["dw"]
        assert X.shape == (rows, d["cip"]) and Y.shape == (rows, d["cop"])
        if own_g:
            assert Y.data_ptr() == op["ptrs"][13].data_ptr()
        assert op["part"].shape == (2 * d["tiles"], st.SUM_SLOTS,
                                    d["cop"] + 4 * d["cip"] + d["hidp"])


@pytest.mark.parametrize("rows,K,N,sms", [(262144, 384, 384, 132), (262144, 384, 128, 132),
                                          (262144, 128, 768, 132), (131072, 48, 768, 132),
                                          (131072, 400, 400, 132), (9600, 48, 48, 132),
                                          (64, 432, 432, 132), (640, 16, 16, 7)])
def test_wgrad_plan_covers_every_row_once(rows, K, N, sms):
    """The row chunks of csrc/wgrad.cu: chunk z covers [z chunk_rows, min(rows,
    (z + 1) chunk_rows)), in order; none is empty, their union is every row
    once, a chunk is whole 64-row stages, and the CTAs fit the card once."""
    chunk_rows, n_chunks = rb.wgrad_plan(rows, K, N, sms)
    assert chunk_rows % rb.WGRAD_CHUNK == 0
    bounds = [(z * chunk_rows, min(rows, (z + 1) * chunk_rows)) for z in range(n_chunks)]
    assert all(b > a for a, b in bounds)
    covered = np.concatenate([np.arange(a, b) for a, b in bounds])
    np.testing.assert_array_equal(covered, np.arange(rows))
    tiles = -(-K // rb.WGRAD_TILE) * -(-N // rb.WGRAD_TILE)
    assert n_chunks * tiles <= max(sms, tiles)


@pytest.mark.parametrize("K,N", [(48, 400), (384, 128)])
def test_plain_wgrad_matches_outer(K, N):
    """The reduction's plain version (the CPU path of ``wgrad``) is K11's
    ``_outer`` on bf16 operands."""
    g = torch.Generator().manual_seed(K)
    X = torch.randn(256, K, generator=g).bfloat16()
    Y = torch.randn(256, N, generator=g).bfloat16()
    torch.testing.assert_close(rb.wgrad(X, Y), st._outer(X, Y, torch.bfloat16), rtol=1e-6,
                               atol=1e-5)
