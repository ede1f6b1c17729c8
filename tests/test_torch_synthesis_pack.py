"""K3's packed weight stream (threedhumangan_tpu_torch/ops/synthesis_kernel.py::
pack_weight_stream), on the CPU: every product's weights are read back through
a mirror of the kernel's addressing (csrc/synthesis.cu, synthesis_core.cuh)
and compared bit for bit with the padded bf16 weights; the chunk count, the
sizes and the alignment are what the producer warp and the C entry expect.
No JAX here: the kernel's math is held against the JAX package through its
plain version (tests/test_torch_synthesis.py) and on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.ops import synthesis_kernel as sk
from threedhumangan_tpu_torch.utils.misc import pad_to, round16

NB, MODS = 4, (0, 2)
SPADE = syn.SPADE_HIDDEN
STAGE_CAP = 16 * 432 * 2  # the bytes of a ring stage at the widest width K3 takes


def _folded(hidden, mode, seed=0):
    net = syn.SynthesisNetwork(hidden, hidden, hidden, NB, MODS, "batch_norm", mode)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    sin_ = syn.SynthesisInput(2, hidden)
    sin_.reset_parameters(torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        return sk.fold_synthesis_params(net.eval(), sin_, "batch_norm")


def _mods(mode):
    rank1 = sk.rank1_blocks_of(NB, MODS, mode)
    return [i for i in range(NB) if i not in rank1]


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

    def gamma_beta(self, hp):
        """Both heads from their two column passes: chunk column n is unit
        n // 16, head (n // 8) % 2, output column pass * hp/2 + 8 unit + n % 8
        (the gamma/beta epilogue in csrc/synthesis.cu)."""
        h2 = hp // 2
        heads = np.zeros((2, SPADE, hp), np.int16)
        n = np.arange(hp)
        for p in (0, 1):
            img = self.product(SPADE, hp)
            heads[(n // 8) % 2, :, p * h2 + (n // 16) * 8 + n % 8] = img.T
        return heads


def _bits(t, shape):
    return pad_to(t, shape, torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("hidden", [32, 200, 420])
@pytest.mark.parametrize("mode", ["isolated", "mixed", "all"])
def test_stream_reads_back_every_weight_bit_for_bit(mode, hidden):
    """hidden 200 pads to 208: 13 units a gamma/beta pass and 26 n8 tiles a
    conv, neither a multiple of the kernel's 3 consumer warpgroups."""
    folded = _folded(hidden, mode)
    hp = fp = round16(hidden)
    mods = _mods(mode)
    stream, sizes = sk.pack_weight_stream(folded, NB, mods, hp, fp)
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    rd = KernelReader(stream, sizes)
    for i in range(NB):
        for si in (0, 1):
            k = f"b{i}_sp{si}"
            if i in mods:
                np.testing.assert_array_equal(rd.product(fp, SPADE),
                                              _bits(folded[f"{k}_sh_w"], (fp, SPADE)))
                g, b = rd.gamma_beta(hp)
                np.testing.assert_array_equal(g, _bits(folded[f"{k}_g_w"], (SPADE, hp)))
                np.testing.assert_array_equal(b, _bits(folded[f"{k}_bt_w"], (SPADE, hp)))
            np.testing.assert_array_equal(rd.product(hp, hp),
                                          _bits(folded[f"b{i}_conv{si}_w"], (hp, hp)))
    assert rd.chunk == len(sizes) and rd.pos == stream.numel() * 2


@pytest.mark.parametrize("hidden", [32, 200, 420])
@pytest.mark.parametrize("mode", ["isolated", "mixed", "all"])
def test_stream_chunk_count_sizes_and_alignment(mode, hidden):
    hp = fp = round16(hidden)
    mods = _mods(mode)
    stream, sizes = sk.pack_weight_stream(_folded(hidden, mode, seed=3), NB, mods, hp, fp)
    # the producer's walk (csrc/synthesis.cu::produce)
    per_mod = [16 * SPADE * 2] * (fp // 16) + [16 * hp * 2] * (2 * SPADE // 16)
    want = []
    for i in range(NB):
        want += 2 * ((per_mod if i in mods else []) + [16 * hp * 2] * (hp // 16))
    assert sizes == want
    # the C entry's byte count of the whole stream
    expect = sum(2 * ((fp * SPADE * 2 + 2 * SPADE * hp * 2) if i in mods else 0)
                 + 2 * hp * hp * 2 for i in range(NB))
    assert stream.numel() * 2 == sum(sizes) == expect
    offsets = np.cumsum([0] + sizes[:-1])
    assert all(s % 256 == 0 and s <= STAGE_CAP for s in sizes)
    assert all(o % 128 == 0 for o in offsets)


def test_chunk_images_layout():
    """One 16 x 16 chunk by hand: element (k, n) at core matrix (n // 8, k // 8),
    row n % 8, column k % 8."""
    w = torch.arange(256, dtype=torch.float32).reshape(16, 16)
    img = sk.chunk_images(w)
    for k in range(16):
        for n in range(16):
            assert img[((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8] == w[k, n]
