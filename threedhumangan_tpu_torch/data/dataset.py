"""Asset-free synthetic dataset and batching (threedhumangan_tpu/data/dataset.py),
in numpy and PyTorch only.

``SyntheticSHHQDataset`` poses the synthetic SMPL model with a seeded mild
random pose per index and canonicalises it with ``preprocess_smpl_fix_body``;
batches are numpy dicts (``to_tensors`` moves one to a device).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from threedhumangan_tpu_torch.models.smpl import SMPLModel, batch_rodrigues, synthetic_smpl_model

FOV = np.pi * 12 / 180
FOCAL = 1.0 / np.tan(FOV / 2)


def _rx_pi() -> np.ndarray:
    return np.asarray([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def preprocess_smpl_fix_body(pred: Dict, joints: List[int],
                             smpl_tpose_vertices: np.ndarray) -> Dict:
    """Canonicalise one VIBE-style SMPL prediction: fold Rx(pi) @ inverse
    root into the FK matrices, re-skin the vertices, build the weak-
    perspective camera from ``orig_cam``."""
    sx, sy, tx, ty = np.asarray(pred["orig_cam"][0], np.float32)
    sx = sx / 2.0
    skeleton_xyz = np.asarray(pred["joints"][0], np.float32)[joints]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = FOCAL
    R = np.eye(4, dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3], T[1, 3], T[2, 3] = tx, ty, FOCAL / sx

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
    tpose_vertices = np.asarray(smpl_tpose_vertices, np.float32).copy()
    tpose_vertices[..., 1] += 0.35

    return {
        "scales": np.float32(sx),
        "skeletons_xyz": skeleton_xyz.astype(np.float32),
        "intrinsics": K,
        "vertices": vertices.astype(np.float32),
        "tpose_vertices": tpose_vertices,
        "full_pose": body_pose,
        "fk_matrices": fk_matrices.astype(np.float32),
        "lbs_weights": lbs_weights,
        "cano_matrices": cano_matrix,
        "R": R,
        "T": T,
    }


class SyntheticSHHQDataset:
    """Geometrically consistent conditions from the synthetic SMPL model."""

    def __init__(self, **kwargs):
        self.length = kwargs["dataset_length"]
        self.height = kwargs["gen_height"]
        self.width = kwargs["gen_width"]
        self.joints = list(kwargs.get("joints", []))
        self.latent_dim = kwargs["latent_dim"]
        self.label_dim = kwargs.get("label_dim", 26)
        self.smpl_model: SMPLModel = kwargs.get("smpl_model") or synthetic_smpl_model()

    def __len__(self):
        return self.length

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
                                        self.smpl_model.v_template.numpy())
        data["indices"] = np.int32(index)
        data["latents"] = rs.randn(self.latent_dim).astype(np.float32)
        data["images"] = rs.uniform(-1, 1, (self.height, self.width, 3)).astype(np.float32)
        data["masks"] = np.ones((self.height, self.width, 1), np.float32)
        seg = rs.randint(1, self.label_dim, (self.height, self.width))
        data["body_segments"] = seg.astype(np.int64)
        return data


def _collate(items: List[Dict]) -> Dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def iterate_batches(dataset, batch_size: int, *, shuffle: bool = True,
                    seed: int = 0) -> Iterator[Dict]:
    """One epoch of numpy batches (the last partial batch is dropped)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, (len(order) // batch_size) * batch_size, batch_size):
        yield _collate([dataset[int(i)] for i in order[start:start + batch_size]])


def to_tensors(batch: Dict, device=None) -> Dict:
    """numpy batch -> torch tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
