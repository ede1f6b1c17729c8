"""Condition preprocessor, camera half (threedhumangan_tpu/data/preprocessor.py).

Sets up the render camera (``fix_body``: the camera orbits a fixed body) or
re-poses the body (``fix_camera``).  Mesh rasterization is not part of this
class: its outputs condition the discriminator and the sampler's pictures,
not the generator, and eager PyTorch would run it even when nothing reads
it.  Rotation noise comes from an explicit ``torch.Generator``.  Inverses
use ``torch.linalg.inv_ex``: like ``jnp.linalg.inv`` it does not check for
singular input, so it does not make the host wait for the card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from threedhumangan_tpu_torch.models.smpl import euler_angles_to_matrix_xyz


def _pad_rotation_4x4(R: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[0], 1, 1)
    out[:, :3, :3] = R
    return out


class Preprocessor:
    def __init__(self, coordinate_mode: str = "fix_body", h_mean: float = 0.0,
                 v_mean: float = 0.0, h_stddev: float = 0.0, v_stddev: float = 0.0):
        if coordinate_mode not in ("fix_body", "fix_camera"):
            raise NotImplementedError(coordinate_mode)
        self.mode = coordinate_mode
        self.h_mean, self.v_mean = h_mean, v_mean
        self.h_stddev, self.v_stddev = h_stddev, v_stddev

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
            return self._forward_fix_body(data, h_rotation, v_rotation, r_rotation)
        return self._forward_fix_camera(data, h_rotation, v_rotation, r_rotation)

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


def get_preprocessor(meta: Dict) -> Preprocessor:
    return Preprocessor(
        coordinate_mode=meta.get("coordinate_mode", "fix_body"),
        h_mean=meta.get("h_mean", 0.0), v_mean=meta.get("v_mean", 0.0),
        h_stddev=meta.get("h_stddev", 0.0), v_stddev=meta.get("v_stddev", 0.0))
