"""Datasets and batching (threedhumangan_tpu/data/dataset.py), in numpy and
PyTorch only.

``SHHQDataset`` reads an SHHQ-layout tree under the config's ``dataroot``:
per index (files 1-indexed, ``%06d``) ``images/*.png`` resized bilinearly to
the generator's size, white where ``masks/*.png`` is 0, in [-1, 1];
``masks/*.png``; ``body_seg/*.png`` (palette indices, resized nearest,
labels shifted: 0 fake, 1 background, parts from 2); ``inversions/*.npy``
(latents x 2, zeros when absent); and ``smpl/*.pkl`` (a VIBE-style
prediction, read by ``joblib`` when it is importable, else ``pickle``)
canonicalised by ``preprocess_smpl`` (``fix_body`` or ``fix_camera``).
Indices in ``corrupted`` are skipped.  ``image_only`` stops after the images
and latents, ``condition_only`` returns the SMPL conditions alone, and
``inference`` adds the body shape.  The PNGs are decoded by
``data.utils.read_png`` and the per-pixel work runs in the native loader
core (``data.native``).

``SyntheticSHHQDataset`` poses the synthetic SMPL model with a seeded mild
random pose per index and canonicalises it with ``preprocess_smpl_fix_body``.
Batches are numpy dicts (``to_tensors`` moves one to a device).
``make_dataset`` / ``get_dataset`` / ``get_dataset_distributed`` resolve a
config's dataset (the synthetic one when the config names no assets or the
directory has neither ``images/`` nor ``smpl/``); the distributed loader
yields one rank's shard of each epoch.
"""

from __future__ import annotations

import itertools
import os
import pickle
from typing import Dict, Iterator, List

import numpy as np
import torch

from threedhumangan_tpu_torch.data import native
from threedhumangan_tpu_torch.data.utils import read_png
from threedhumangan_tpu_torch.models.smpl import (
    SMPLModel,
    batch_rodrigues,
    get_smpl_model,
    synthetic_smpl_model,
)
from threedhumangan_tpu_torch.utils.misc import resolve_device

FOV = np.pi * 12 / 180
FOCAL = 1.0 / np.tan(FOV / 2)


def _rx_pi() -> np.ndarray:
    return np.asarray([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def _camera(pred: Dict, joints: List[int]):
    """(sx, skeleton, K, R, T) of the weak-perspective camera from ``orig_cam``."""
    sx, sy, tx, ty = np.asarray(pred["orig_cam"][0], np.float32)
    sx = sx / 2.0
    skeleton_xyz = np.asarray(pred["joints"][0], np.float32)[joints]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = FOCAL
    R = np.eye(4, dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[1, 3], T[2, 3] = tx, ty, FOCAL / sx
    return sx, skeleton_xyz, K, R, T


def _tpose(smpl_tpose_vertices: np.ndarray) -> np.ndarray:
    tpose_vertices = np.asarray(smpl_tpose_vertices, np.float32).copy()
    tpose_vertices[..., 1] += 0.35
    return tpose_vertices


def preprocess_smpl_fix_body(pred: Dict, joints: List[int], smpl_tpose_vertices: np.ndarray,
                             inference: bool = False) -> Dict:
    """Canonicalise one VIBE-style SMPL prediction: fold Rx(pi) @ inverse
    root into the FK matrices, re-skin the vertices, build the weak-
    perspective camera from ``orig_cam``; ``inference`` adds the body shape."""
    sx, skeleton_xyz, K, R, T = _camera(pred, joints)
    body_pose = np.asarray(pred["full_pose"][0], np.float32)
    tpose_vertices_shaped = np.asarray(pred["tpose_vertices"][0], np.float32)
    fk_matrices = np.asarray(pred["fk_matrices"][0], np.float32)
    inverse_root = np.linalg.inv(body_pose[0])
    cano_matrix = np.eye(4, dtype=np.float32)
    cano_matrix[:3, :3] = _rx_pi() @ inverse_root
    fk_matrices = np.einsum("ij,bjk->bik", cano_matrix, fk_matrices)

    lbs_weights = np.asarray(pred["lbs_weights"], np.float32)
    vert_fk = np.einsum("vj,jkl->vkl", lbs_weights, fk_matrices)
    tpose_homo = np.concatenate(
        [tpose_vertices_shaped, np.ones_like(tpose_vertices_shaped[:, :1])], axis=-1)
    vertices = np.einsum("vij,vj->vi", vert_fk, tpose_homo)[:, :3]
    skel_homo = np.concatenate([skeleton_xyz, np.ones_like(skeleton_xyz[:, :1])], -1)
    skeleton_xyz = (cano_matrix @ skel_homo.T).T[:, :3]
    out = {
        "scales": np.float32(sx),
        "skeletons_xyz": skeleton_xyz.astype(np.float32),
        "intrinsics": K,
        "vertices": vertices.astype(np.float32),
        "tpose_vertices": _tpose(smpl_tpose_vertices),
        "full_pose": body_pose,
        "fk_matrices": fk_matrices.astype(np.float32),
        "lbs_weights": lbs_weights,
        "cano_matrices": cano_matrix,
        "R": R,
        "T": T,
    }
    if inference:
        out["body_shape"] = np.asarray(pred["betas"][0], np.float32)
    return out


def preprocess_smpl_fix_camera(pred: Dict, joints: List[int], smpl_tpose_vertices: np.ndarray,
                               inference: bool = False) -> Dict:
    """The ``fix_camera`` variant: the body stays posed, the camera is fixed
    (its cam2world from the weak-perspective camera)."""
    sx, skeleton_xyz, K, R, T = _camera(pred, joints)
    cam2world = np.linalg.inv(R @ T)
    out = {
        "scales": np.float32(sx),
        "skeletons_xyz": skeleton_xyz.astype(np.float32),
        "intrinsics": K,
        "tpose_vertices": _tpose(smpl_tpose_vertices),
        "tpose_vertices_shaped": np.asarray(pred["tpose_vertices"][0], np.float32),
        "full_pose": np.asarray(pred["full_pose"][0], np.float32),
        "fk_matrices": np.asarray(pred["fk_matrices"][0], np.float32),
        "lbs_weights": np.asarray(pred["lbs_weights"], np.float32),
        "cam2world_matrices": cam2world.astype(np.float32),
        "R": R,
        "T": T,
    }
    if inference:
        out["body_shape"] = np.asarray(pred["betas"][0], np.float32)
    return out


def preprocess_smpl(pred: Dict, joints: List[int], smpl_tpose_vertices: np.ndarray,
                    coordinate_mode: str = "fix_body", inference: bool = False) -> Dict:
    """Canonicalise by ``coordinate_mode``."""
    if coordinate_mode == "fix_body":
        return preprocess_smpl_fix_body(pred, joints, smpl_tpose_vertices, inference)
    if coordinate_mode == "fix_camera":
        return preprocess_smpl_fix_camera(pred, joints, smpl_tpose_vertices, inference)
    raise NotImplementedError(coordinate_mode)


def _load_pickle(path: str):
    try:
        import joblib
    except ImportError:
        joblib = None
    if joblib is not None:
        return joblib.load(path)
    with open(path, "rb") as f:
        return pickle.load(f)


class SHHQDataset:
    """An SHHQ-layout tree on disk (module docstring)."""

    corrupted = [118464]

    def __init__(self, **kwargs):
        self.root = kwargs["dataroot"]
        self.length = kwargs["dataset_length"]
        self.height = kwargs["gen_height"]
        self.width = kwargs["gen_width"]
        self.joints = list(kwargs.get("joints", []))
        self.latent_dim = kwargs["latent_dim"]
        self.inference = kwargs.get("inference", False)
        self.image_only = kwargs.get("image_only", False)
        self.condition_only = kwargs.get("condition_only", False)
        self.coordinate_mode = kwargs.get("coordinate_mode", "fix_body")
        self.smpl_model: SMPLModel = kwargs.get("smpl_model") or get_smpl_model(
            os.path.join("datasets", "SMPL_NEUTRAL.pkl"))
        self.smpl_tpose_vertices = self.smpl_model.v_template.numpy()

    def __len__(self):
        return self.length

    def _path(self, sub: str, index: int, ext: str) -> str:
        return os.path.join(self.root, sub, f"{index + 1:06d}.{ext}")

    def _load_image(self, path: str, nearest: bool = False) -> np.ndarray:
        return native.resize_u8(read_png(path), self.height, self.width, nearest=nearest)

    def _skip_corrupted(self, index: int) -> int:
        while index in self.corrupted:
            index = (index + 1) % len(self)
        return index

    def _latents(self, index: int):
        p = self._path("inversions", index, "npy")
        return 2 * np.load(p)[:self.latent_dim] if os.path.exists(p) else None

    def get_all_latents(self) -> np.ndarray:
        """The latent-pool initial values: the inversions x 2 (zeros where absent)."""
        latents = np.zeros([len(self), self.latent_dim], np.float32)
        for i in range(len(self)):
            lat = self._latents(i)
            if lat is not None:
                latents[i] = lat
        return latents

    def _load_smpl(self, index: int) -> Dict:
        return preprocess_smpl(_load_pickle(self._path("smpl", index, "pkl")), self.joints,
                               self.smpl_tpose_vertices, self.coordinate_mode, self.inference)

    def __getitem__(self, index) -> Dict:
        index = self._skip_corrupted(index)
        if self.condition_only:
            return self._load_smpl(index)
        rgb = self._load_image(self._path("images", index, "png"))
        mask = self._load_image(self._path("masks", index, "png"), nearest=True)
        mask2d = mask if mask.ndim == 2 else mask[..., 0]
        data = {"indices": np.int32(index),
                "images": native.normalize_masked_image(rgb, mask2d),
                "masks": mask.astype(np.float32) / 127.5 - 1.0}
        lat = self._latents(index)
        data["latents"] = (lat.astype(np.float32) if lat is not None
                           else np.zeros([self.latent_dim], np.float32))
        if self.image_only:
            return data
        seg = self._load_image(self._path("body_seg", index, "png"), nearest=True)
        if seg.ndim == 3:
            seg = seg[..., 0]
        data["body_segments"] = native.shift_segment_labels(seg.astype(np.int64))
        if self.joints:
            data.update(self._load_smpl(index))
        return data


class SyntheticSHHQDataset:
    """Geometrically consistent conditions from the synthetic SMPL model."""

    def __init__(self, **kwargs):
        self.length = kwargs["dataset_length"]
        self.height = kwargs["gen_height"]
        self.width = kwargs["gen_width"]
        self.joints = list(kwargs.get("joints", []))
        self.latent_dim = kwargs["latent_dim"]
        self.inference = kwargs.get("inference", False)
        self.label_dim = kwargs.get("label_dim", 26)
        self.smpl_model: SMPLModel = kwargs.get("smpl_model") or synthetic_smpl_model()

    def __len__(self):
        return self.length

    def get_all_latents(self) -> np.ndarray:
        """Latent-pool initial values (the JAX dataset's RandomState(1234) draw)."""
        return np.random.RandomState(1234).randn(len(self), self.latent_dim).astype(np.float32)

    def __getitem__(self, index) -> Dict:
        rs = np.random.RandomState(index)
        J = self.smpl_model.num_joints
        aa = 0.2 * rs.randn(J, 3).astype(np.float32)
        rot = batch_rodrigues(torch.as_tensor(aa[None]))[0]
        betas = 0.5 * rs.randn(1, 10).astype(np.float32)
        with torch.no_grad():
            smpl_out = self.smpl_model.forward(torch.as_tensor(betas), rot[None], pose2rot=False)
        pred = {
            "orig_cam": np.asarray([[1.8, 1.8, 0.0, 0.0]], np.float32),
            "joints": smpl_out["joints"].numpy(),
            "full_pose": rot[None].numpy(),
            "tpose_vertices": smpl_out["tpose_vertices"].numpy(),
            "fk_matrices": smpl_out["fk_matrices"].numpy(),
            "lbs_weights": self.smpl_model.lbs_weights.numpy(),
            "betas": betas,
        }
        data = preprocess_smpl_fix_body(pred, self.joints or list(range(J)),
                                        self.smpl_model.v_template.numpy(), self.inference)
        data["indices"] = np.int32(index)
        data["latents"] = rs.randn(self.latent_dim).astype(np.float32)
        data["images"] = rs.uniform(-1, 1, (self.height, self.width, 3)).astype(np.float32)
        data["masks"] = np.ones((self.height, self.width, 1), np.float32)
        seg = rs.randint(1, self.label_dim, (self.height, self.width))
        data["body_segments"] = seg.astype(np.int64)
        return data


def _collate(items: List[Dict]) -> Dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def iterate_batches(dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                    start: int = 0, world_size: int = 1, rank: int = 0) -> Iterator[Dict]:
    """One epoch of rank ``rank``'s numpy batches from its batch ``start`` on
    (the JAX package's ``iterate_batches``): the seeded shuffle of every
    index, then every ``world_size``-th from ``rank``, in batches of
    ``batch_size`` (the rank's share; the last partial batch is dropped)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    order = order[rank::world_size]
    for i0 in range(start * batch_size, (len(order) // batch_size) * batch_size, batch_size):
        yield _collate([dataset[int(i)] for i in order[i0:i0 + batch_size]])


def batches_per_rank(n_items: int, batch_size: int, world_size: int = 1) -> int:
    """The batches of an epoch that every rank has: a rank's share is at
    least ``n_items // world_size`` items."""
    return (n_items // world_size) // batch_size


_RESERVED_KEYS = ("name", "dataset", "batch_size", "world_size", "rank", "trainer")


_DATASETS = {"SHHQDataset": SHHQDataset, "SyntheticSHHQDataset": SyntheticSHHQDataset}


def make_dataset(kind: str, **meta):
    """Resolve by class name: the synthetic dataset when the config names no
    assets (``dataroot`` "synthetic") or the directory has neither
    ``images/`` nor ``smpl/``."""
    meta = {k: v for k, v in meta.items() if k not in _RESERVED_KEYS}
    root = meta.get("dataroot")
    if kind == "SyntheticSHHQDataset" or root in (None, "", "synthetic"):
        return SyntheticSHHQDataset(**meta)
    if not any(os.path.isdir(os.path.join(root, d)) for d in ("images", "smpl")):
        return SyntheticSHHQDataset(**meta)
    return _DATASETS[kind](**meta)


def get_dataset(kind: str, batch_size: int = 1, **meta):
    """(loader factory, dataset); ``loader(seed, shuffle)`` yields one epoch
    of numpy batches, in order unless ``shuffle``."""
    ds = make_dataset(kind, **meta)

    def loader(seed: int = 0, shuffle: bool = False):
        return iterate_batches(ds, batch_size, shuffle=shuffle, seed=seed)

    return loader, ds


def get_dataset_distributed(kind: str, world_size: int, rank: int, batch_size: int, **meta):
    """(loader factory, dataset) for rank ``rank`` of ``world_size``;
    ``batch_size`` is the rank's share of the batch.  ``loader(seed,
    shuffle, start)`` yields the rank's batches of one epoch from batch
    ``start`` on, stopping at ``batches_per_rank`` so that every rank takes
    as many steps."""
    ds = make_dataset(kind, **meta)

    def loader(seed: int = 0, shuffle: bool = True, start: int = 0):
        stop = batches_per_rank(len(ds), batch_size, world_size)
        return itertools.islice(iterate_batches(ds, batch_size, shuffle=shuffle, seed=seed,
                                                start=start, world_size=world_size, rank=rank),
                                max(stop - start, 0))

    return loader, ds


def to_tensors(batch: Dict, device="cuda") -> Dict:
    """numpy batch -> torch tensors on ``device``.  For a CUDA device each
    array is copied into pinned host memory and sent with
    ``non_blocking=True``.  The copy is queued on the calling thread's
    current stream, which for the trainer's prefetch worker is the device's
    default stream; the train step launches its kernels on that same
    default stream, so stream order makes every kernel that reads the batch
    wait for its copy.  The pinned buffers come from PyTorch's caching host
    allocator, which keeps each until its copy has completed."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=device.type == "cuda")
    return out
