"""SMPL constants, posing and the fix-body camera, in plain PyTorch.

``synthetic_smpl_arrays`` is the stand-in body the benchmark runs on (the
real ``SMPL_NEUTRAL.pkl`` is not in the repository): vertices on a capsule
grid, joints along the spine, skinning by joint proximity, the same numpy
draws as the port's ``synthetic_smpl_model``.  Both sides get these arrays.

``pose_conditions`` poses a batch of bodies (axis-angle ``(N, J, 3)``,
betas ``(N, 10)``) by linear blend skinning and canonicalises each as the
SHHQ loader's fix-body preprocessing does: the FK matrices with Rx(pi) times
the inverse root rotation folded in, the vertices re-skinned, the skeleton
moved alike, a weak-perspective camera from ``orig_cam`` (1.8, 1.8, 0, 0).
``fix_body_camera`` is the preprocessor's camera half: the camera orbits the
body by the yaw ``h`` and pitch ``v``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

FOV = math.pi * 12 / 180
FOCAL = 1.0 / math.tan(FOV / 2)
ORIG_CAM = (1.8, 1.8, 0.0, 0.0)


def synthetic_smpl_arrays(seed: int = 0, num_verts: int = 6890, num_faces: int = 13776,
                          num_joints: int = 24) -> Dict[str, np.ndarray]:
    """numpy arrays of the synthetic body (``num_verts`` rounds down to a
    rows x cols grid): v_template (V, 3), shapedirs (V, 3, 10), posedirs
    ((J-1)*9, V*3), J_regressor (J, V), parents (J,), lbs_weights (V, J),
    faces (F, 3)."""
    rs = np.random.RandomState(seed)
    cols = max(8, int(np.sqrt(num_verts / 2)))
    rows = max(2, num_verts // cols)
    num_verts = rows * cols
    theta = np.tile(np.linspace(0, 2 * np.pi, cols, endpoint=False), rows)
    height = np.repeat(np.linspace(-0.9, 0.9, rows), cols)
    radius = 0.25 + 0.02 * rs.randn(num_verts)
    v_template = np.stack([radius * np.cos(theta), height, radius * np.sin(theta)], -1)
    parents = np.zeros(num_joints, np.int64)
    for j in range(1, num_joints):
        parents[j] = rs.randint(0, j)
    joint_pos = np.stack([np.zeros(num_joints), np.linspace(-0.8, 0.8, num_joints),
                          np.zeros(num_joints)], -1)
    d = ((v_template[None].astype(np.float32) - joint_pos[:, None]) ** 2).sum(-1)
    J_regressor = np.exp(-d / 0.05)
    J_regressor = J_regressor / J_regressor.sum(1, keepdims=True)
    w = np.exp(-d.T / 0.1)
    lbs_weights = w / w.sum(1, keepdims=True)
    quads = []
    for r in range(rows - 1):
        for c in range(cols):
            v00, v01 = r * cols + c, r * cols + (c + 1) % cols
            v10, v11 = (r + 1) * cols + c, (r + 1) * cols + (c + 1) % cols
            quads += [[v00, v01, v10], [v01, v11, v10]]
    faces = np.asarray(quads, np.int64)
    faces = (faces[:num_faces] if len(faces) >= num_faces
             else np.tile(faces, (-(-num_faces // len(faces)), 1))[:num_faces])
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(v_template=f32(v_template), shapedirs=f32(0.01 * rs.randn(num_verts, 3, 10)),
                posedirs=f32(0.001 * rs.randn((num_joints - 1) * 9, num_verts * 3)),
                J_regressor=f32(J_regressor), parents=parents, lbs_weights=f32(lbs_weights),
                faces=faces)


def rodrigues(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    axis = aa / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    rx, ry, rz = axis.unbind(-1)
    zero = torch.zeros_like(rx)
    K = torch.stack([zero, -rz, ry, rz, zero, -rx, -ry, rx, zero], -1).reshape(
        aa.shape[:-1] + (3, 3))
    outer = axis[..., :, None] * axis[..., None, :]
    return cos * torch.eye(3, dtype=aa.dtype, device=aa.device) + (1 - cos) * outer + sin * K


def euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    """Rx(x) @ Ry(y) @ Rz(z) of (..., 3) angles."""
    x, y, z = euler.unbind(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    m = lambda *e: torch.stack(e, -1).reshape(x.shape + (3, 3))
    rx = m(one, zero, zero, zero, torch.cos(x), -torch.sin(x), zero, torch.sin(x), torch.cos(x))
    ry = m(torch.cos(y), zero, torch.sin(y), zero, one, zero, -torch.sin(y), zero, torch.cos(y))
    rz = m(torch.cos(z), -torch.sin(z), zero, torch.sin(z), torch.cos(z), zero, zero, zero, one)
    return rx @ ry @ rz


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def _skin(weights, transforms, points):
    """Blend (N, J, 4, 4) by (V, J) weights and apply to (N, V, 3)."""
    T = torch.einsum("vj,njkl->nvkl", weights, transforms)
    homo = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return torch.einsum("nvij,nvj->nvi", T, homo)[..., :3]


def pose_conditions(smpl: Dict[str, np.ndarray], aa: torch.Tensor, betas: torch.Tensor,
                    joints=None) -> Dict[str, torch.Tensor]:
    """The fix-body conditions of N posed bodies, on ``aa``'s device, float32."""
    dev = aa.device
    t = lambda k: torch.as_tensor(smpl[k], device=dev)
    v_template, lbs_weights = t("v_template"), t("lbs_weights")
    parents = [int(p) for p in smpl["parents"]]
    N, J = aa.shape[:2]
    rot = rodrigues(aa.float())
    v_shaped = v_template[None] + torch.einsum("nl,vdl->nvd", betas.float(), t("shapedirs"))
    joints_rest = torch.einsum("jv,nvd->njd", t("J_regressor"), v_shaped)
    rel = joints_rest.clone()
    rel[:, 1:] = joints_rest[:, 1:] - joints_rest[:, parents[1:]]
    chain = [_homogeneous(rot[:, 0], rel[:, 0])]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ _homogeneous(rot[:, j], rel[:, j]))
    chain = torch.stack(chain, 1)
    posed_joints = chain[:, :, :3, 3]
    fk = chain.clone()
    fk[..., 3] = chain[..., 3] - torch.einsum("njik,njk->nji", chain[..., :3], joints_rest)
    # canonicalise: Rx(pi) @ inverse root; the loader skins the shaped T-pose
    # (no pose blend shapes) by the canonical FK
    rx_pi = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=dev))
    cano = torch.eye(4, device=dev).repeat(N, 1, 1)
    cano[:, :3, :3] = rx_pi @ torch.linalg.inv(rot[:, 0])
    fk = cano[:, None] @ fk
    vertices = _skin(lbs_weights, fk, v_shaped)
    sel = list(range(J)) if joints is None else list(joints)
    skel = posed_joints[:, sel]
    skel = torch.einsum("nij,nkj->nki", cano, torch.cat([skel, torch.ones_like(skel[..., :1])],
                                                        -1))[..., :3]
    sx, _, tx, ty = ORIG_CAM
    sx = sx / 2.0
    K = torch.eye(4, device=dev)
    K[0, 0] = K[1, 1] = FOCAL
    T = torch.eye(4, device=dev)
    T[0, 3], T[1, 3], T[2, 3] = tx, ty, FOCAL / sx
    tpose = v_template.clone()
    tpose[:, 1] += 0.35
    rep = lambda m: m[None].expand((N,) + m.shape).contiguous()
    return {"scales": torch.full((N,), sx, device=dev), "skeletons_xyz": skel,
            "intrinsics": rep(K), "vertices": vertices, "tpose_vertices": rep(tpose),
            "full_pose": rot, "fk_matrices": fk, "lbs_weights": rep(lbs_weights),
            "R": rep(torch.eye(4, device=dev)), "T": rep(T)}


def fix_body_camera(cond: Dict[str, torch.Tensor], h: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """cam2world (N, 4, 4) of the camera orbiting the body: euler (pi - v,
    -h, 0) after the root rotation, world2cam = R @ T @ that, inverted."""
    euler = torch.stack([math.pi - v, -h, torch.zeros_like(h)], -1)
    Rot = cond["full_pose"][:, 0] @ euler_xyz(euler)
    pad = torch.eye(4, device=h.device).repeat(h.shape[0], 1, 1)
    pad[:, :3, :3] = Rot
    return torch.linalg.inv(cond["R"] @ cond["T"] @ pad)
