"""The PyTorch port's real-data path on the CPU, on an SHHQ-layout tree
written at test time (images/, masks/, body_seg/, inversions/, smpl/ and an
``SMPL_NEUTRAL.pkl``, as ``test_shhq_fixture.py`` builds it; PNGs by PIL,
with its adaptive row filters, gray masks and palette labels): the port's
PNG reader against PIL, its native loader core against the JAX package's
and against its own numpy versions, ``SHHQDataset`` and ``get_all_latents``
against the JAX package's, ``load_smpl_model`` against the JAX package's,
the dataset's resolution, and a two-step NANO ``Trainer`` run on the tree
that never imports JAX."""

import os
import pickle
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from threedhumangan_tpu import configs as jconfigs
from threedhumangan_tpu.data import dataset as jds
from threedhumangan_tpu.data import native as jnative
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data import native
from threedhumangan_tpu_torch.data.utils import read_png, write_png
from threedhumangan_tpu_torch.models import smpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 4
SRC_H, SRC_W = 37, 21  # resized to NANO's 16 x 8: neither side a multiple


def _meta(root, **over):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(dataroot=root, dataset_length=N_ITEMS, joints=list(range(24)), **over)
    return {k: v for k, v in meta.items() if k not in ("dataset", "name", "batch_size")}


def _smooth(rs, h, w, c):
    """A smooth image with a little noise (the filters matter on it)."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    chans = [np.sin(6 * x * rs.uniform(0.5, 2) + 4 * y * rs.uniform(0.5, 2) + rs.uniform(0, 6))
             for _ in range(c)]
    img = 127.5 + 110 * np.stack(chans, -1) + rs.randn(h, w, c) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """N_ITEMS items in the reference layout (1-indexed %06d), the SMPL
    asset, and extra PNG kinds for the reader."""
    root = tmp_path_factory.mktemp("shhq")
    for sub in ("images", "masks", "body_seg", "inversions", "smpl", "other"):
        os.makedirs(root / sub)
    model = smpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    smpl.save_smpl_model(model, str(root / "SMPL_NEUTRAL.pkl"))
    jmodel = jsmpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    rs = np.random.RandomState(7)
    J = model.num_joints
    palette = rs.randint(0, 256, (25, 3)).astype(np.uint8)
    for i in range(1, N_ITEMS + 1):
        Image.fromarray(_smooth(rs, SRC_H, SRC_W, 3)).save(root / "images" / f"{i:06d}.png")
        mask = (_smooth(rs, SRC_H, SRC_W, 1)[..., 0] > 110).astype(np.uint8) * 255
        Image.fromarray(mask).save(root / "masks" / f"{i:06d}.png")
        seg = Image.fromarray(rs.randint(0, 25, (SRC_H, SRC_W)).astype(np.uint8), mode="P")
        seg.putpalette(palette.tobytes())
        seg.save(root / "body_seg" / f"{i:06d}.png")
        if i != 3:  # item 3 has no inversion: zeros
            np.save(root / "inversions" / f"{i:06d}.npy", rs.randn(20).astype(np.float32))
        aa = 0.2 * rs.randn(J, 3).astype(np.float32)
        rot = np.asarray(jsmpl.batch_rodrigues(jnp.asarray(aa[None])))[0]
        betas = 0.3 * rs.randn(1, 10).astype(np.float32)
        out = jmodel.forward(jnp.asarray(betas), jnp.asarray(rot[None]), pose2rot=False)
        pred = {"orig_cam": np.asarray([[1.7, 1.6, 0.05, -0.02]], np.float32),
                "joints": np.asarray(out["joints"]),
                "full_pose": np.broadcast_to(rot[None], (1, J, 3, 3)).copy(),
                "tpose_vertices": np.asarray(out["tpose_vertices"]),
                "fk_matrices": np.asarray(out["fk_matrices"]),
                "lbs_weights": np.asarray(jmodel.lbs_weights), "betas": betas}
        with open(root / "smpl" / f"{i:06d}.pkl", "wb") as f:
            pickle.dump(pred, f)
    for mode, c in (("LA", 2), ("RGBA", 4), ("L", 1), ("RGB", 3)):
        img = _smooth(rs, 29, 33, c)
        Image.fromarray(img[..., 0] if c == 1 else img, mode).save(root / "other" / f"{mode}.png")
    # PIL's encoder does not choose every filter type: rows cycling through all five
    write_png(str(root / "other" / "cycled.png"), _smooth(rs, 31, 27, 3), filters=(0, 1, 2, 3, 4))
    return str(root)


def _pngs(tree):
    return [os.path.join(tree, sub, n) for sub in ("images", "masks", "body_seg", "other")
            for n in sorted(os.listdir(os.path.join(tree, sub)))]


@pytest.fixture
def no_native(monkeypatch):
    """The numpy versions of the loader core, as on a host with no compiler."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


# ---------------------------------------------------------------------------
# PNG files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("core", ["native", "numpy"])
def test_read_png_equals_pil(tree, core, request):
    if core == "numpy":
        request.getfixturevalue("no_native")
    else:
        assert native.get_lib() is not None
    files = _pngs(tree)
    modes = {Image.open(p).mode for p in files}
    assert modes == {"RGB", "L", "P", "LA", "RGBA"}
    for p in files:
        want = np.asarray(Image.open(p))
        got = read_png(p)
        assert got.dtype == np.uint8 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)


def test_read_png_sees_every_row_filter(tree):
    """The files the reader is held on use all five row filter types."""
    seen = set()
    for p in _pngs(tree):
        with open(p, "rb") as f:
            data = f.read()
        w, h, _, kind, _, _, _ = struct.unpack(">IIBBBBB", data[16:29])
        c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[kind]
        idat, pos = b"", 8
        while pos < len(data):
            n, tag = struct.unpack(">I4s", data[pos:pos + 8])
            idat += data[pos + 8:pos + 8 + n] if tag == b"IDAT" else b""
            pos += 12 + n
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
        seen |= set(raw[:, 0].tolist())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_write_png_round_trips_through_pil(tmp_path, filters):
    rs = np.random.RandomState(3)
    for c in (1, 2, 3, 4):
        img = _smooth(rs, 13, 17, c)
        p = str(tmp_path / f"{c}.png")
        write_png(p, img, filters=filters)
        np.testing.assert_array_equal(np.asarray(Image.open(p)).reshape(img.shape), img)
        np.testing.assert_array_equal(read_png(p).reshape(img.shape), img)
    idx = rs.randint(0, 7, (11, 9)).astype(np.uint8)
    p = str(tmp_path / "p.png")
    write_png(p, idx, palette=rs.randint(0, 256, (7, 3)).astype(np.uint8), filters=filters)
    assert Image.open(p).mode == "P"
    np.testing.assert_array_equal(np.asarray(Image.open(p)), idx)


def test_read_png_refuses_16_bit_and_interlaced(tmp_path):
    p16 = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900).save(p16)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(p16)
    p = str(tmp_path / "flat.png")
    write_png(p, np.zeros((4, 4, 3), np.uint8))
    with open(p, "rb") as f:
        data = bytearray(f.read())
    data[28] = 1  # the IHDR interlace byte (its CRC is not checked)
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(p)


# ---------------------------------------------------------------------------
# the native loader core
# ---------------------------------------------------------------------------

RESIZES = [((37, 21), (16, 8)), ((16, 8), (37, 21)), ((1024, 512), (512, 256)), ((5, 5), (5, 5))]


def _core_outputs():
    rs = np.random.RandomState(11)
    out = []
    for (sh, sw), (dh, dw) in RESIZES:
        for c in (None, 1, 3):
            shape = (sh, sw) if c is None else (sh, sw, c)
            src = rs.randint(0, 256, shape).astype(np.uint8)
            for nearest in (False, True):
                out.append(("resize", shape, nearest, (dh, dw), src))
    return out


@pytest.mark.parametrize("ref", ["jax", "numpy"])
def test_native_core_equals_jax(ref, monkeypatch):
    """The port's native functions equal the JAX package's native ones, and
    the port's numpy versions equal its native ones, byte for byte."""
    assert native.get_lib() is not None and jnative.get_lib() is not None
    rs = np.random.RandomState(12)
    rgb = rs.randint(0, 256, (19, 13, 3)).astype(np.uint8)
    mask = (rs.rand(19, 13) > 0.4).astype(np.uint8) * rs.randint(1, 256, (19, 13)).astype(np.uint8)
    seg = rs.randint(0, 25, (19, 13)).astype(np.int64)
    got = {"norm": native.normalize_masked_image(rgb, mask),
           "norm_nomask": native.normalize_masked_image(rgb, None),
           "shift": native.shift_segment_labels(seg.copy()),
           "resize": [native.resize_u8(src, *d, nearest=n) for _, _, n, d, src in _core_outputs()]}
    if ref == "jax":
        want = {"norm": jnative.normalize_masked_image(rgb, mask),
                "norm_nomask": jnative.normalize_masked_image(rgb, None),
                "shift": jnative.shift_segment_labels(seg.copy()),
                "resize": [jnative.resize_u8(src, *d, nearest=n)
                           for _, _, n, d, src in _core_outputs()]}
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        want = {"norm": native.normalize_masked_image(rgb, mask),
                "norm_nomask": native.normalize_masked_image(rgb, None),
                "shift": native.shift_segment_labels(seg.copy()),
                "resize": [native.resize_u8(src, *d, nearest=n)
                           for _, _, n, d, src in _core_outputs()]}
    for k in ("norm", "norm_nomask", "shift"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for (_, shape, n, d, _), a, b in zip(_core_outputs(), got["resize"], want["resize"]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=f"{shape} -> {d}, nearest {n}")


def test_native_library_is_built_under_build(tmp_path):
    lib = native.get_lib()
    from threedhumangan_tpu_torch._build import BUILD_DIR

    assert os.path.dirname(lib._name) == BUILD_DIR
    assert os.path.basename(lib._name).startswith("dataloader_")


# ---------------------------------------------------------------------------
# SMPL asset
# ---------------------------------------------------------------------------


def test_load_smpl_model_equals_jax(tree):
    path = os.path.join(tree, "SMPL_NEUTRAL.pkl")
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    assert raw["J_regressor"].format == "csc"  # scipy.sparse, as in the asset
    got, want = smpl.load_smpl_model(path), jsmpl.load_smpl_model(path)
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got.parents, want.parents)
    np.testing.assert_array_equal(got.faces, want.faces)
    # the asset round-trips the synthetic model it was written from
    src = smpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    np.testing.assert_array_equal(got.posedirs.numpy(), src.posedirs.numpy())
    np.testing.assert_allclose(got.J_regressor.numpy(), src.J_regressor.numpy(), rtol=1e-7)
    assert smpl.get_smpl_model(path).num_verts == src.num_verts
    assert smpl.get_smpl_model(os.path.join(tree, "absent.pkl")).num_verts == \
        smpl.synthetic_smpl_model().num_verts


# ---------------------------------------------------------------------------
# SHHQDataset
# ---------------------------------------------------------------------------


def _pair(tree, **over):
    model = smpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    jmodel = jsmpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    return (ds.SHHQDataset(smpl_model=model, **_meta(tree, **over)),
            jds.SHHQDataset(smpl_model=jmodel, **_meta(tree, **over)))


FLAGS = [{}, {"image_only": True}, {"condition_only": True}, {"inference": True}]


@pytest.mark.parametrize("mode", ["fix_body", "fix_camera"])
@pytest.mark.parametrize("flags", FLAGS, ids=["all", "image_only", "condition_only",
                                              "inference"])
def test_shhq_items_equal_jax(tree, mode, flags):
    mine, ref = _pair(tree, coordinate_mode=mode, **flags)
    for i in range(N_ITEMS):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b), i
        for k in b:
            va, vb = np.asarray(a[k]), np.asarray(b[k])
            assert va.dtype == vb.dtype and va.shape == vb.shape, (i, k)
            np.testing.assert_array_equal(va, vb, err_msg=f"item {i} {k}")
    if not flags.get("condition_only"):
        item = mine[0]
        assert item["images"].shape == (16, 8, 3)
        assert (item["images"][item["masks"] < 0] == 1.0).all()  # white background
        assert "body_segments" not in item or item["body_segments"].min() >= 1


def test_shhq_corrupted_skip_and_latents_equal_jax(tree):
    mine, ref = _pair(tree)
    mine.corrupted = ref.corrupted = [0, 1]
    assert mine[0]["indices"] == ref[0]["indices"] == 2
    assert mine[N_ITEMS - 1]["indices"] == N_ITEMS - 1
    lat, jlat = mine.get_all_latents(), ref.get_all_latents()
    assert lat.dtype == jlat.dtype == np.float32
    np.testing.assert_array_equal(lat, jlat)
    assert not lat[2].any() and lat[0].any()  # item 3 has no inversion
    stored = np.load(os.path.join(tree, "inversions", "000001.npy"))
    np.testing.assert_array_equal(lat[0], 2 * stored[:lat.shape[1]])


def test_make_dataset_resolves_the_tree(tree, tmp_path):
    model = smpl.synthetic_smpl_model(num_verts=96, num_faces=160)
    meta = dict(_meta(tree), smpl_model=model)
    assert isinstance(ds.make_dataset("SHHQDataset", **meta), ds.SHHQDataset)
    os.makedirs(tmp_path / "empty")
    for root in ("synthetic", str(tmp_path / "empty")):
        assert isinstance(ds.make_dataset("SHHQDataset", **dict(meta, dataroot=root)),
                          ds.SyntheticSHHQDataset)
    loader, d = ds.get_dataset("SHHQDataset", batch_size=2, **meta)
    batch = next(iter(loader()))
    assert isinstance(d, ds.SHHQDataset) and batch["images"].shape == (2, 16, 8, 3)
    np.testing.assert_array_equal(batch["indices"], [0, 1])
    jloader, _ = jds.get_dataset("SHHQDataset", batch_size=2,
                                 **dict(meta, smpl_model=jsmpl.synthetic_smpl_model(
                                     num_verts=96, num_faces=160)))
    jbatch = next(iter(jloader()))
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the trainer on the tree, with no JAX
# ---------------------------------------------------------------------------

_TRAIN = r"""
import os, sys, types
import numpy as np
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import SHHQDataset
from threedhumangan_tpu_torch.models.smpl import get_smpl_model
from threedhumangan_tpu_torch.trainers.base_trainer import Trainer
tree, out = sys.argv[1], sys.argv[2]
config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
config.update(dataset="SHHQDataset", dataroot=tree, dataset_length=4)
opt = types.SimpleNamespace(output_dir=out, device="cpu", model_save_interval=2,
                            model_keep_interval=2, sample_interval=0, n_epochs=5, seed=0,
                            tensorboard=0)
smpl = get_smpl_model(os.path.join(tree, "SMPL_NEUTRAL.pkl"))
trainer = Trainer(0, 1, opt, config, smpl_model=smpl)
assert isinstance(trainer.dataset, SHHQDataset)
lat = trainer.ts.G.latent_pool.latents.detach().numpy()
stored = np.load(os.path.join(tree, "inversions", "000001.npy"))
np.testing.assert_array_equal(lat[0], 2 * stored[:lat.shape[1]])
trainer.run(max_steps=2)
assert trainer.step == 2
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
ref = sorted(m for m in sys.modules if m == "threedhumangan_tpu"
             or m.startswith("threedhumangan_tpu."))
assert not ref, ref
print("SHHQ_TRAIN_OK")
"""


def test_trainer_runs_two_steps_on_the_tree_without_jax(tree, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", _TRAIN, tree, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SHHQ_TRAIN_OK" in proc.stdout
    assert "dataset SHHQDataset, 4 items under" in proc.stdout
    assert jconfigs.MAP3DBN_NANO["dataroot"] == "synthetic"  # the shipped config is untouched
