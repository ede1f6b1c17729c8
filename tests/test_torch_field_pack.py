"""K2's packed weight stream (threedhumangan_tpu_torch/ops/raymarch.py::
pack_field_stream), on the CPU: every weight of every image is read back
through a mirror of the kernel's addressing (csrc/raymarch.cu's producer
walk, synthesis_core.cuh's B descriptor) and compared bit for bit with the
padded bf16 tables of ``fold_film_tables``, sigma's column of the colour
product included; the side tables equal the folded biases; the chunk count,
sizes, alignment and stage capacity are what the producer and the C entry
expect; the kernel's entry refuses the folded tables.  No JAX here: the kernel's math is held against the JAX package
through its plain version (tests/test_torch_field.py) and on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.utils.misc import pad_to

B, G = 2, 31
UNITS = 54  # n8 tiles a product may have: 3 warpgroups x 18 (csrc/raymarch.cu)


def _case(hidden, nb, seed=0):
    field = CoordConcatSiren(3, hidden, G, hidden, nb,
                             generator=torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    freq = torch.as_tensor(0.3 * rs.randn(B, nb * hidden).astype(np.float32))
    phase = torch.as_tensor(0.3 * rs.randn(B, nb * hidden).astype(np.float32))
    with torch.no_grad():
        shared, per_image = rm.fold_film_tables(field, freq, phase, torch.bfloat16)
        w = rm.flat_weights(field)
        freq_k, phase_k = rm.film_tables(freq, phase, nb)
    return shared, per_image, w, freq_k, phase_k


class KernelReader:
    """The kernel's view of one image's stream: the producer's chunk walk
    (a chunk starts where the last one ended) and, inside a chunk image, the
    byte that wgmma's B descriptor addresses for (k, n): core matrix (n // 8,
    k // 8) at 256 bytes a column group and 128 a K half, row n % 8, element
    k % 8."""

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


def _bits(t, shape):
    return pad_to(t, shape, torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("hidden", [32, 384, 420])
def test_stream_reads_back_every_weight_bit_for_bit(hidden, nb):
    """Per image, in the producer's order: the first layer's column products,
    w_net0, the trunk layers, the colour layer with w_sigma in column H, the
    head [rgb | feat]."""
    shared, per_image, w, freq_k, _ = _case(hidden, nb)
    d = rm.field_dims(3 + G, hidden, hidden, nb)
    k0p, n0p, hp, nc, headp = d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"]
    stream, sizes = rm.pack_field_stream(w, freq_k)
    assert stream.dtype == torch.bfloat16 and stream.shape == (B, sum(sizes) // 2)
    words = stream.view(torch.int16).numpy()
    head = torch.cat([shared["w_rgb"], shared["w_feat"]], 1)
    for b in range(B):
        rd = KernelReader(words[b], sizes)
        first = np.concatenate([rd.product(k0p, n) for n in d["first"]], 1)
        np.testing.assert_array_equal(first, _bits(shared["w_first"], (k0p, n0p)))
        np.testing.assert_array_equal(rd.product(n0p, hp),
                                      _bits(per_image["w_net0"][b], (n0p, hp)))
        for i in range(nb - 1):
            np.testing.assert_array_equal(rd.product(hp, hp),
                                          _bits(per_image["w_net_stk"][b, i], (hp, hp)))
        color = rd.product(hp, nc)
        np.testing.assert_array_equal(color[:, :hidden],
                                      _bits(per_image["w_color_x"][b], (hp, hidden)))
        np.testing.assert_array_equal(color[:, hidden], _bits(shared["w_sigma"][:, 0], (hp,)))
        assert not color[:, hidden + 1:].any() and not color[hidden:].any()
        np.testing.assert_array_equal(rd.product(hp, headp), _bits(head, (hp, headp)))
        assert rd.chunk == len(sizes) and rd.pos == sum(sizes)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("hidden", [32, 384, 420])
def test_side_tables_equal_the_folded_tables(hidden, nb):
    shared, per_image, w, freq_k, phase_k = _case(hidden, nb, seed=1)
    d = rm.field_dims(3 + G, hidden, hidden, nb)
    b_first, b_net, w_cd, b_color, b_sigma, b_head = rm.field_side_tables(w, freq_k, phase_k, d)
    eq = lambda got, ref: np.testing.assert_array_equal(
        got.numpy(), pad_to(ref.float(), got.shape, torch.float32).numpy())
    eq(b_first, shared["b_first"][0])
    eq(b_net, per_image["b_net"])
    eq(w_cd, per_image["w_color_d"])
    eq(b_color, per_image["b_color"][:, 0])
    eq(b_sigma, shared["b_sigma"].reshape(1))
    eq(b_head, torch.cat([shared["b_rgb"], shared["b_feat"]], 1)[0])


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("hidden", [32, 384, 420])
def test_stream_chunk_count_sizes_alignment_and_stage(hidden, nb):
    _, _, w, freq_k, _ = _case(hidden, nb, seed=2)
    d = rm.field_dims(3 + G, hidden, hidden, nb)
    k0p, n0p, hp, nc, headp = d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"]
    stream, sizes = rm.pack_field_stream(w, freq_k)
    # the producer's walk (csrc/raymarch.cu::produce)
    want = []
    for n in d["first"]:
        want += [16 * n * 2] * (k0p // 16)
    want += [16 * hp * 2] * (n0p // 16) + [16 * hp * 2] * ((nb - 1) * hp // 16)
    want += [16 * nc * 2] * (hp // 16) + [16 * headp * 2] * (hp // 16)
    assert sizes == want
    # the first layer's products split n0p / 8 tiles evenly, each within a product
    assert sum(d["first"]) == n0p and max(d["first"]) - min(d["first"]) <= 8
    assert all(n % 8 == 0 and n // 8 <= UNITS for n in d["first"] + [hp, nc, headp])
    # the C entry's byte count of one image's stream, and of the batch
    img = 2 * (k0p * n0p + n0p * hp + (nb - 1) * hp * hp + hp * nc + hp * headp)
    assert sum(sizes) == img and stream.numel() * 2 == B * img
    # each chunk fits the ring stage (the widest product's chunk) and starts
    # 256-byte aligned in every image (the bulk copy needs 16)
    stage = 16 * max([hp, nc, headp] + d["first"]) * 2
    offsets = np.cumsum([0] + sizes[:-1])
    assert all(s % 256 == 0 and s <= stage for s in sizes)
    assert all(o % 256 == 0 for o in offsets) and img % 256 == 0
    # sigma's column lies in the colour product, past the colour columns
    assert hidden < nc <= hp + 8


def test_kernel_entry_rejects_folded_tables():
    """K2 folds FiLM in its own weight pack: the plain version's folded
    tables are refused with a clear error before anything is built."""
    hidden, nb, S = 32, 2, 8
    shared, per_image, _, _, _ = _case(hidden, nb)
    packed = torch.zeros(B, 8 * S, 3 + G + 3, dtype=torch.bfloat16)
    z_vals = torch.ones(B, 8, S)
    with pytest.raises(ValueError, match="flat_weights"):
        rm.field_render_cuda(shared, per_image, packed, z_vals, S)
