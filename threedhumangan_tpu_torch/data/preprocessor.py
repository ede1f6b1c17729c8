"""Condition preprocessor (threedhumangan_tpu/data/preprocessor.py).

Sets up the render camera (``fix_body``: the camera orbits a fixed body) or
re-poses the body (``fix_camera``), then, when the preprocessor holds the
mesh's faces and their DensePose labels, rasterizes the posed SMPL mesh
through the render camera (K7, ``ops.rasterize.rasterize_mesh_tiled``) into
``rasterized_segments`` (body-part label + 2, background 1) and
``rasterized_semantics`` (T-pose xyz of the winning face's nearest corner).
Generation needs neither, so a preprocessor built without faces skips the
rasterizer.  Rotation noise comes from an explicit ``torch.Generator``.
Inverses use ``torch.linalg.inv_ex``: like ``jnp.linalg.inv`` it does not
check for singular input, so it does not make the host wait for the card.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from threedhumangan_tpu_torch.models.smpl import euler_angles_to_matrix_xyz
from threedhumangan_tpu_torch.ops.rasterize import rasterize_mesh_tiled


def _pad_rotation_4x4(R: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[0], 1, 1)
    out[:, :3, :3] = R
    return out


class Preprocessor:
    def __init__(self, coordinate_mode: str = "fix_body", h_mean: float = 0.0,
                 v_mean: float = 0.0, h_stddev: float = 0.0, v_stddev: float = 0.0,
                 gen_height: int = 0, gen_width: int = 0,
                 smpl_faces: Optional[np.ndarray] = None,
                 faces_to_labels: Optional[np.ndarray] = None, raster_tile: int = 32,
                 raster_faces_per_tile: int = 2048):
        if coordinate_mode not in ("fix_body", "fix_camera"):
            raise NotImplementedError(coordinate_mode)
        self.mode = coordinate_mode
        self.h_mean, self.v_mean = h_mean, v_mean
        self.h_stddev, self.v_stddev = h_stddev, v_stddev
        self.height, self.width = gen_height, gen_width
        self.raster_tile = raster_tile
        self.raster_faces_per_tile = raster_faces_per_tile
        self.faces = None if smpl_faces is None else torch.as_tensor(
            np.asarray(smpl_faces, np.int64))
        self.faces_to_labels = None if faces_to_labels is None else torch.as_tensor(
            np.asarray(faces_to_labels, np.int64))

    def __call__(self, data: Dict, rotate: bool, generator: torch.Generator) -> Dict:
        """Random camera rotation (when ``rotate``) around the mean view."""
        B = data["scales"].shape[0]
        dev = data["scales"].device
        rot = 1.0 if rotate else 0.0
        h = torch.randn(B, generator=generator, device=dev) * (self.h_stddev * rot) + self.h_mean
        v = torch.randn(B, generator=generator, device=dev) * (self.v_stddev * rot) + self.v_mean
        return self.forward_with_rotation(data, h, v, torch.zeros_like(h))

    def forward_with_rotation(self, data: Dict, h_rotation, v_rotation, r_rotation) -> Dict:
        if self.mode == "fix_body":
            data = self._forward_fix_body(data, h_rotation, v_rotation, r_rotation)
        else:
            data = self._forward_fix_camera(data, h_rotation, v_rotation, r_rotation)
        return data if self.faces is None else self._forward_rasterize(data)

    def _forward_fix_body(self, data, h_rotation, v_rotation, r_rotation):
        """Rotate the camera around the fixed body; euler x = pi - v flips
        the camera upside down (image rows run down, world y runs up)."""
        root_rotation = data["full_pose"][:, 0]
        euler = torch.stack([math.pi - v_rotation, -h_rotation, -r_rotation], -1)
        R = root_rotation @ euler_angles_to_matrix_xyz(euler)
        world2cam = data["R"] @ data["T"] @ _pad_rotation_4x4(R)
        out = dict(data)
        out["cam2world_matrices"] = torch.linalg.inv_ex(world2cam.float()).inverse
        return out

    def _forward_fix_camera(self, data, h_rotation, v_rotation, r_rotation):
        """Rotate the body under the fixed camera."""
        euler = torch.stack([v_rotation, h_rotation, r_rotation], -1)
        body_rotation = torch.linalg.inv_ex(
            _pad_rotation_4x4(euler_angles_to_matrix_xyz(euler))).inverse
        tpose = data["tpose_vertices_shaped"]
        fk = torch.einsum("bjk,bikl->bijl", body_rotation, data["fk_matrices"])
        vert_fk = torch.einsum("bvj,bjkl->bvkl", data["lbs_weights"], fk)
        tpose_homo = torch.cat([tpose, torch.ones_like(tpose[..., :1])], -1)
        skel = data["skeletons_xyz"]
        skel_homo = torch.cat([skel, torch.ones_like(skel[..., :1])], -1)
        out = dict(data)
        out["fk_matrices"] = fk
        out["vertices"] = torch.einsum("bvij,bvj->bvi", vert_fk, tpose_homo)[..., :3]
        out["skeletons_xyz"] = torch.einsum("bjk,bik->bij", body_rotation, skel_homo)[..., :3]
        return out


    @staticmethod
    def screen_vertices(data) -> torch.Tensor:
        """Posed vertices projected through the render camera onto the ray
        grid: (B, V, 3) = (x, y, camera depth)."""
        verts = data["vertices"].float()
        world2cam = torch.linalg.inv_ex(data["cam2world_matrices"].float()).inverse
        focal = data["intrinsics"][:, 0, 0].float()
        v_cam = (torch.einsum("bij,bvj->bvi", world2cam[:, :3, :3], verts)
                 + world2cam[:, None, :3, 3])
        return torch.stack([focal[:, None] * v_cam[..., 0] / v_cam[..., 2],
                            focal[:, None] * v_cam[..., 1] / v_cam[..., 2], v_cam[..., 2]], -1)

    def _forward_rasterize(self, data):
        """Project the posed mesh through the render camera and rasterize it."""
        dev = data["vertices"].device
        faces = self.faces.to(dev)
        pix_to_face, bary, _ = rasterize_mesh_tiled(
            self.screen_vertices(data), faces, (self.height, self.width), tile=self.raster_tile,
            max_faces_per_tile=self.raster_faces_per_tile)
        bg = pix_to_face < 0
        face_safe = pix_to_face.clamp(min=0).long()
        # winning vertex: the corner with the largest barycentric weight
        corner = torch.argmax(bary, -1, keepdim=True)
        pix_to_vert = torch.gather(faces[face_safe], -1, corner)[..., 0]
        semantics = data["tpose_vertices"][0][pix_to_vert]
        out = dict(data)
        out["rasterized_semantics"] = torch.where(bg[..., None], 0.0, semantics)
        segments = self.faces_to_labels.to(dev)[face_safe] + 2
        out["rasterized_segments"] = torch.where(bg, 1, segments).to(torch.int32)
        return out


def load_face_labels(faces: np.ndarray, densepose_path: Optional[str] = None) -> np.ndarray:
    """SMPL face -> DensePose body-part label (0..23) from the vendored
    ``datasets/densepose_data.json``; the table covers the real SMPL
    topology only, so a mesh with another face count (the synthetic test
    meshes) gets 24 height-ordered pseudo-parts by face index."""
    repo_root = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
    for c in (densepose_path, os.path.join(repo_root, "datasets", "densepose_data.json")):
        if c and os.path.exists(c):
            with open(c) as f:
                dp = json.load(f)
            s2d = np.asarray(dp["smpl_faces_to_densepose_faces"], np.int64)
            d2l = np.asarray(dp["densepose_faces_to_labels"], np.int64)
            if len(faces) == len(s2d):
                return d2l[s2d]
            if densepose_path is not None:
                raise ValueError(f"densepose table at {c} covers {len(s2d)} faces but the "
                                 f"SMPL model has {len(faces)}")
    return (np.arange(len(faces)) * 24 // max(len(faces), 1)).astype(np.int64)


def get_preprocessor(meta: Dict, smpl_model=None,
                     densepose_path: Optional[str] = None) -> Preprocessor:
    """The camera half alone, or with ``smpl_model`` also the rasterizer
    (its faces and their DensePose labels)."""
    raster = {}
    if smpl_model is not None:
        raster = dict(gen_height=meta["gen_height"], gen_width=meta["gen_width"],
                      smpl_faces=smpl_model.faces,
                      faces_to_labels=load_face_labels(smpl_model.faces, densepose_path),
                      raster_tile=meta.get("raster_tile", 32),
                      raster_faces_per_tile=meta.get("raster_faces_per_tile", 2048))
    return Preprocessor(
        coordinate_mode=meta.get("coordinate_mode", "fix_body"),
        h_mean=meta.get("h_mean", 0.0), v_mean=meta.get("v_mean", 0.0),
        h_stddev=meta.get("h_stddev", 0.0), v_stddev=meta.get("v_stddev", 0.0), **raster)
