"""Ray generation and volume integration
(threedhumangan_tpu/models/volume_rendering.py).

Randomness comes from an explicit ``torch.Generator``; tensors are
(B, rays, steps, C) with rays = H*W flattened row-major.  ``sample_pdf``
(hierarchical sampling) is not ported: ``hierarchical_sample`` is False in
every shipped config.  Nor is camera sampling (see
``transform_sampled_points``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from threedhumangan_tpu_torch.utils.misc import normalize_vecs


def ray_integration(field_out: torch.Tensor, z_vals: torch.Tensor, *,
                    last_back: bool = False, white_back: bool = False):
    """Alpha-composite per-ray samples (noise-free, relu density clamp:
    every shipped config's ``clamp_mode``).

    field_out (B, rays, steps, C+1) with sigma last; z_vals (B, rays, steps, 1).
    Returns (features (B, rays, C), depth (B, rays, 1), weights (B, rays, steps, 1)).
    """
    features, sigmas = field_out[..., :-1], field_out[..., -1:]
    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]
    deltas = torch.cat([deltas, 1e9 * torch.ones_like(deltas[:, :, :1])], -2)
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :, :1]), 1.0 - alphas + 1e-12], -2)
    transmittance = torch.cumprod(shifted, -2)[:, :, :-1]
    weights = alphas * transmittance
    weights_sum = weights.sum(2)
    w_last = weights[:, :, -1:] + (1.0 - weights_sum)[:, :, None]
    weights_res = torch.cat([weights[:, :, :-1], w_last], -2)
    features_final = ((weights_res if last_back else weights) * features).sum(-2)
    depth_final = (weights_res * z_vals).sum(-2)
    if last_back:
        weights = weights_res
    if white_back:
        features_final = features_final + 1.0 - weights_sum
    return features_final, depth_final, weights


def get_initial_rays_weak_perspective(focals, scales, num_steps: int, resolution: Tuple[int, int],
                                      ray_start: float, ray_end: float):
    """Camera-space rays of a weak-perspective camera.  Returns
    (points (B, HW, S, 3), z_vals (B, HW, S, 1), dirs (B, HW, 3))."""
    W, H = resolution
    B = focals.shape[0]
    dev = focals.device
    span = W / H
    xs = torch.linspace(-span, span, W, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    x = grid_x.reshape(1, H * W).expand(B, H * W)
    y = grid_y.reshape(1, H * W).expand(B, H * W)
    z = focals.float()[:, None].expand(B, H * W)
    rays_d_cam = normalize_vecs(torch.stack([x, y, z], -1))
    z_vals = torch.linspace(ray_start, ray_end, num_steps, dtype=torch.float32, device=dev)
    z_vals = z_vals.reshape(1, 1, num_steps, 1) + (focals / scales).float().reshape(B, 1, 1, 1)
    z_vals = z_vals.expand(B, H * W, num_steps, 1)
    points = rays_d_cam[:, :, None, :] * z_vals
    return points, z_vals, rays_d_cam


def expand_ray_directions(ray_directions: torch.Tensor, num_steps: int) -> torch.Tensor:
    """(B, rays, 3) -> (B, rays*steps, 3)."""
    B, R, _ = ray_directions.shape
    return ray_directions[:, :, None, :].expand(B, R, num_steps, 3).reshape(B, R * num_steps, 3)


def perturb_points(points, z_vals, ray_directions, generator: torch.Generator):
    """Uniform per-sample jitter within one step interval."""
    dist = z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :]
    u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype, device=z_vals.device)
    offset = (u - 0.5) * dist
    return points + offset * ray_directions[:, :, None, :], z_vals + offset


def transform_sampled_points(points, z_vals, ray_directions, cam2world_matrix,
                             generator: Optional[torch.Generator] = None,
                             perturb: bool = False):
    """Jitter samples (``perturb``) and map camera space to world through
    the given cam2world.  Returns (points (B, R, S, 3), z_vals, dirs (B, R, 3)).

    The JAX function also samples a random camera for its pitch/yaw
    outputs; generation always supplies cam2world and reads neither, so
    that sampling is not ported."""
    B, R, S, _ = points.shape
    if perturb:
        points, z_vals = perturb_points(points, z_vals, ray_directions, generator)
    cam2world_matrix = cam2world_matrix.float()
    rot, trans = cam2world_matrix[:, :3, :3], cam2world_matrix[:, :3, 3]
    pts = torch.einsum("bij,bnj->bni", rot, points.reshape(B, R * S, 3)) + trans[:, None]
    dirs = torch.einsum("bij,bnj->bni", rot, ray_directions)
    return pts.reshape(B, R, S, 3), z_vals, dirs
