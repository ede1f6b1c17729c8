"""SMPL body model: linear blend skinning + per-point geometric features
(threedhumangan_tpu/models/smpl.py).

``load_smpl_model`` reads the ``SMPL_NEUTRAL.pkl`` asset (``save_smpl_model``
writes a model in its layout); ``get_smpl_model`` takes it from the given
path or ``datasets/``, else the synthetic stand-in.
``synthetic_smpl_model`` draws the same numpy ``RandomState`` stream as the
JAX version, so both packages build identical constants from one seed.
``get_geo_features`` is the 31-d conditioning; it runs through
``ops.geo.geo_features`` (K1 on a CUDA tensor, its plain version on a CPU
tensor), or, with the fused geo kernel off, in torch around the 1-NN of
``ops.knn`` (K6, or the plain expanded-form search).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from threedhumangan_tpu_torch.ops.geo import build_vertex_features, geo_features
from threedhumangan_tpu_torch.ops.knn import knn_gather, knn_points, nn_points

NUM_JOINTS = 24


def batch_rodrigues(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1)
    K = K.reshape(*aa.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)
    outer = axis[..., :, None] * axis[..., None, :]
    return cos * ident + (1 - cos) * outer + sin * K


def euler_angles_to_matrix_xyz(euler: torch.Tensor) -> torch.Tensor:
    """XYZ-convention euler angles (..., 3) -> (..., 3, 3)."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(*x.shape, 3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(*x.shape, 3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(*x.shape, 3, 3)
    return rx @ ry @ rz


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the static kinematic tree, unrolled.
    Returns (posed joints (B, J, 3), rel transforms (B, J, 4, 4))."""
    B, J = joints.shape[:2]
    parent_idx = torch.as_tensor(np.asarray(parents[1:]), device=joints.device)
    rel_joints = joints - torch.cat([torch.zeros_like(joints[:, :1]), joints[:, parent_idx]], 1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, 1, 4)

    def make_T(R, t):
        return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)

    transforms = [make_T(rot_mats[:, 0], rel_joints[:, 0])]
    for j in range(1, J):
        local = make_T(rot_mats[:, j], rel_joints[:, j])
        transforms.append(transforms[int(parents[j])] @ local)
    chain = torch.stack(transforms, 1)
    posed_joints = chain[:, :, :3, 3]
    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    correction = torch.einsum("bjik,bjk->bji", chain, joints_homo)
    rel = chain - torch.cat([chain.new_zeros(B, J, 4, 3), correction[..., None]], -1)
    return posed_joints, rel


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights,
        pose2rot: bool = True):
    """Linear blend skinning.  Returns (A, v_shaped, verts, J, J_transformed)."""
    B = max(betas.shape[0], pose.shape[0])
    V = v_template.shape[0]
    v_shaped = v_template[None] + torch.einsum("bl,vdl->bvd", betas, shapedirs)
    joints = torch.einsum("jv,bvd->bjd", J_regressor, v_shaped)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    if pose2rot:
        rot_mats = batch_rodrigues(pose.reshape(B, -1, 3)).reshape(B, -1, 3, 3)
    else:
        rot_mats = pose.reshape(B, -1, 3, 3)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(B, V, 3)
    J_transformed, A = batch_rigid_transform(rot_mats, joints, parents)
    T = torch.einsum("vj,bjkl->bvkl", lbs_weights, A)
    v_homo = torch.cat([v_posed, v_posed.new_ones(B, V, 1)], -1)
    verts = torch.einsum("bvij,bvj->bvi", T, v_homo)[..., :3]
    return A, v_shaped, verts, joints, J_transformed


@dataclasses.dataclass
class SMPLModel:
    """SMPL constants as tensors (``parents``/``faces`` stay numpy)."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # ((J-1)*9, V*3)
    J_regressor: torch.Tensor  # (J, V)
    parents: np.ndarray        # (J,)
    lbs_weights: torch.Tensor  # (V, J)
    faces: np.ndarray          # (F, 3)

    @property
    def num_verts(self):
        return self.v_template.shape[0]

    @property
    def num_joints(self):
        return self.J_regressor.shape[0]

    def forward(self, betas: torch.Tensor, full_pose: torch.Tensor, pose2rot: bool = True) -> dict:
        A, v_shaped, verts, joints_shaped, joints = lbs(
            betas, full_pose, self.v_template, self.shapedirs, self.posedirs,
            self.J_regressor, self.parents, self.lbs_weights, pose2rot=pose2rot)
        return {
            "fk_matrices": A,
            "tpose_vertices": v_shaped,
            "vertices": verts,
            "joints_shaped": joints_shaped,
            "joints": joints,
            "betas": betas,
            "full_pose": full_pose,
            "lbs_weights": self.lbs_weights,
        }


def synthetic_smpl_model(seed: int = 0, num_verts: int = 384, num_faces: int = 512,
                         num_joints: int = NUM_JOINTS) -> SMPLModel:
    """Shape-compatible random stand-in for the SMPL asset: vertices on a
    capsule grid of rows x cols (so ``num_verts`` rounds down), joints along
    the spine, skinning weights by joint proximity.  Same RandomState draws,
    in the same order, as the JAX version."""
    rs = np.random.RandomState(seed)
    cols = max(8, int(np.sqrt(num_verts / 2)))
    rows = max(2, num_verts // cols)
    num_verts = rows * cols
    theta = np.tile(np.linspace(0, 2 * np.pi, cols, endpoint=False), rows)
    height = np.repeat(np.linspace(-0.9, 0.9, rows), cols)
    radius = 0.25 + 0.02 * rs.randn(num_verts)
    v_template = np.stack(
        [radius * np.cos(theta), height, radius * np.sin(theta)], axis=-1).astype(np.float32)

    parents = np.zeros(num_joints, np.int64)
    for j in range(1, num_joints):
        parents[j] = rs.randint(0, j)

    joint_y = np.linspace(-0.8, 0.8, num_joints)
    joint_pos = np.stack([np.zeros(num_joints), joint_y, np.zeros(num_joints)], -1)
    d = ((v_template[None, :, :] - joint_pos[:, None, :]) ** 2).sum(-1)
    J_regressor = np.exp(-d / 0.05)
    J_regressor = J_regressor / J_regressor.sum(axis=1, keepdims=True)
    w = np.exp(-d.T / 0.1)
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    quads = []
    for r in range(rows - 1):
        for c in range(cols):
            v00 = r * cols + c
            v01 = r * cols + (c + 1) % cols
            v10 = (r + 1) * cols + c
            v11 = (r + 1) * cols + (c + 1) % cols
            quads.append([v00, v01, v10])
            quads.append([v01, v11, v10])
    faces = np.asarray(quads, np.int64)
    if len(faces) >= num_faces:
        faces = faces[:num_faces]
    else:
        faces = np.tile(faces, (-(-num_faces // len(faces)), 1))[:num_faces]

    n_betas = 10
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return SMPLModel(
        v_template=f32(v_template),
        shapedirs=f32(0.01 * rs.randn(num_verts, 3, n_betas)),
        posedirs=f32(0.001 * rs.randn((num_joints - 1) * 9, num_verts * 3)),
        J_regressor=f32(J_regressor),
        parents=parents,
        lbs_weights=f32(lbs_weights),
        faces=faces,
    )


def load_smpl_model(path: str) -> SMPLModel:
    """SMPL constants from the ``SMPL_NEUTRAL.pkl`` layout (a latin-1 pickle:
    ``v_template``, ``shapedirs`` (V, 3, n), ``posedirs`` (V, 3, P),
    ``J_regressor`` (J, V), dense or ``scipy.sparse``, ``kintree_table``,
    ``weights``, ``f``), as JAX ``models/smpl.py::load_smpl_model`` reads it:
    ``posedirs`` becomes (P, V * 3) and the first 10 shape directions kept."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    dense = lambda x: np.asarray(x.toarray() if hasattr(x, "toarray") else x)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    posedirs = np.asarray(data["posedirs"], np.float32)
    return SMPLModel(
        v_template=f32(data["v_template"]),
        shapedirs=f32(np.asarray(data["shapedirs"])[:, :, :10]),
        posedirs=f32(posedirs.reshape(-1, posedirs.shape[-1]).T),
        J_regressor=f32(dense(data["J_regressor"])),
        parents=np.asarray(data["kintree_table"][0], np.int64).clip(0),
        lbs_weights=f32(data["weights"]),
        faces=np.asarray(data["f"], np.int64),
    )


def save_smpl_model(model: SMPLModel, path: str) -> None:
    """Write ``model`` in the ``SMPL_NEUTRAL.pkl`` layout that
    ``load_smpl_model`` reads (``J_regressor`` as a ``scipy.sparse`` matrix,
    as in the asset)."""
    import scipy.sparse

    V, P = model.num_verts, model.posedirs.shape[0]
    kintree = np.stack([model.parents, np.arange(model.num_joints)]).astype(np.int64)
    kintree[0, 0] = -1
    data = {"v_template": model.v_template.numpy(), "shapedirs": model.shapedirs.numpy(),
            "posedirs": model.posedirs.numpy().T.reshape(V, 3, P),
            "J_regressor": scipy.sparse.csc_matrix(model.J_regressor.numpy()),
            "kintree_table": kintree, "weights": model.lbs_weights.numpy(),
            "f": model.faces.astype(np.uint32)}
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)


def get_smpl_model(path: Optional[str] = None) -> SMPLModel:
    """The asset at ``path``, else ``datasets/SMPL_NEUTRAL.pkl`` under the
    working directory or the checkout, else ``synthetic_smpl_model()``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for c in (path, os.path.join("datasets", "SMPL_NEUTRAL.pkl"),
              os.path.join(repo, "datasets", "SMPL_NEUTRAL.pkl")):
        if c and os.path.exists(c):
            return load_smpl_model(c)
    return synthetic_smpl_model()


def get_geo_features(points, skeletons, vertices, tpose_vertices, fk_matrices, lbs_weights,
                     legacy_mode: bool = False, use_pallas_knn: bool = True,
                     use_pallas_geo: bool = True, ray_layout=None) -> torch.Tensor:
    """Per-point 31-d geometric conditioning (JAX smpl.py:331-405): 24 joint
    distances, inverse-LBS canonicalised coords and T-pose coords of the
    nearest posed vertex, and that vertex's distance.

    points (B, P, 3); skeletons (B, J, 3); vertices/tpose_vertices (B, V, 3);
    fk_matrices (B, J, 4, 4); lbs_weights (B, V, J).  Column order is
    [cano 3, joints 24, tpose 3, dist 1], or [joints 24, cano 3, tpose 3,
    dist 1] with ``legacy_mode``.

    ``use_pallas_geo`` (the default, as on the JAX package's accelerator
    runs) runs the whole stage through ``ops.geo.geo_features`` (K1).
    Otherwise the stage runs in torch as the JAX XLA branch, with the 1-NN
    from ``ops.knn.nn_points`` (K6) under ``use_pallas_knn`` or from the
    plain ``ops.knn.knn_points`` without it.  ``ray_layout`` = (rays a row,
    points a ray) when the points are rays x steps lets K1 and K6 tile points
    that lie close together; the result does not depend on it."""
    c = lambda t: t.float().contiguous()
    if use_pallas_geo:
        vfeat = build_vertex_features(tpose_vertices, fk_matrices, lbs_weights)
        return geo_features(c(points), c(vertices), vfeat, c(skeletons), legacy_mode=legacy_mode,
                            ray_layout=ray_layout)
    B, P, _ = points.shape
    V = vertices.shape[1]
    points = c(points)
    diff = points[:, :, None, :] - skeletons.float()[:, None, :, :]
    joint_dists = torch.sqrt(torch.sum(torch.square(diff), -1) + 1e-12) / 2.4
    ik = torch.linalg.inv_ex(fk_matrices.float()).inverse  # no error check: no host sync
    vertex_ik = torch.einsum("bvj,bjkl->bvkl", lbs_weights.float(), ik)
    if use_pallas_knn:
        d2, idx = nn_points(points, c(vertices), ray_layout)
    else:
        d2, idx = knn_points(points, vertices, k=1)
    point_ik = knn_gather(vertex_ik.reshape(B, V, 16), idx)[:, :, 0].reshape(B, P, 4, 4)
    homo = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    cano = torch.einsum("bpij,bpj->bpi", point_ik, homo)[..., :3]
    cano = torch.stack([cano[..., 0] / 2.0, (cano[..., 1] + 0.2) / 2.0, cano[..., 2] / 1.3], -1)
    tpose = knn_gather(tpose_vertices.float(), idx)[:, :, 0]
    tpose = torch.cat([tpose[..., :2], tpose[..., 2:] / 0.2], -1)
    ndist = torch.sqrt(d2[..., :1]) / 1.3
    cols = ([joint_dists, cano, tpose, ndist] if legacy_mode
            else [cano, joint_dists, tpose, ndist])
    return torch.cat(cols, -1)
