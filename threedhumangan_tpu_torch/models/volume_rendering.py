"""Ray generation, camera sampling, hierarchical sampling and volume
integration (threedhumangan_tpu/models/volume_rendering.py).

Randomness comes from explicit draws or an explicit ``torch.Generator``:
``ray_integration`` takes its nerf noise as a tensor or a generator,
``sample_pdf`` its uniforms, ``perturb_points`` and
``sample_camera_positions`` a generator.  Tensors are (B, rays, steps, C)
with rays = H*W flattened row-major.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from threedhumangan_tpu_torch.utils.misc import normalize_vecs


def ray_integration(field_out: torch.Tensor, z_vals: torch.Tensor, *, noise_std: float = 0.5,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, last_back: bool = False,
                    white_back: bool = False, clamp_mode: str = "relu",
                    fill_mode: Optional[str] = None):
    """Alpha-composite per-ray samples (JAX ``ray_integration``).

    field_out (B, rays, steps, C+1) with sigma last; z_vals (B, rays, steps, 1).
    Returns (features (B, rays, C), depth (B, rays, 1), weights (B, rays, steps, 1)).

    The nerf noise ``noise_std * n`` is added to sigma where a draw is
    given: ``noise`` (standard normal, sigma's shape) or, without it, a
    draw from ``generator``; with neither there is none (JAX: no ``rng``).
    ``clamp_mode`` 'relu' or 'softplus': ``F.softplus`` returns its input
    above 20 where ``jax.nn.softplus`` adds log1p(exp(-x)) < 2.1e-9, a
    difference below 1e-8 relative.  ``fill_mode`` 'debug' paints rays of
    opacity < 0.9 red (the first channel 1, the rest 0); 'weight' fills
    every channel with the ray's opacity.
    """
    features, sigmas = field_out[..., :-1], field_out[..., -1:]
    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]
    deltas = torch.cat([deltas, 1e9 * torch.ones_like(deltas[:, :, :1])], -2)
    if noise is None and generator is not None:
        noise = torch.randn(sigmas.shape, generator=generator, dtype=sigmas.dtype,
                            device=sigmas.device)
    if noise is not None:
        sigmas = sigmas + noise_std * noise.to(sigmas.dtype)
    if clamp_mode == "softplus":
        density = F.softplus(sigmas)
    elif clamp_mode == "relu":
        density = torch.relu(sigmas)
    else:
        raise ValueError("clamp_mode must be 'relu' or 'softplus'")
    alphas = 1.0 - torch.exp(-deltas * density)
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
    if fill_mode == "debug":
        red = torch.zeros_like(features_final)
        red[..., 0] = 1.0
        features_final = torch.where(weights_sum < 0.9, red, features_final)
    elif fill_mode == "weight":
        features_final = weights_sum.expand(features_final.shape)
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


def get_initial_rays_trig(n: int, num_steps: int, fov: float, resolution: Tuple[int, int],
                          ray_start: float, ray_end: float, device=None):
    """Pinhole-camera rays from a field of view in degrees.  Returns
    (points (n, W*H, S, 3), z_vals (n, W*H, S, 1), dirs (n, W*H, 3))."""
    W, H = resolution
    span = W / H
    xs = torch.linspace(-span, span, W, dtype=torch.float32, device=device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    x, y = grid_x.reshape(-1), grid_y.reshape(-1)
    focal = 1.0 / math.tan(math.pi * (fov / 180.0) / 2.0)
    rays_d_cam = normalize_vecs(torch.stack([x, y, torch.full_like(x, focal)], -1))
    z_vals = torch.linspace(ray_start, ray_end, num_steps, dtype=torch.float32, device=device)
    z_vals = z_vals.reshape(1, num_steps, 1).expand(W * H, num_steps, 1)
    points = rays_d_cam[:, None, :] * z_vals
    return (points[None].expand((n,) + points.shape), z_vals[None].expand((n,) + z_vals.shape),
            rays_d_cam[None].expand((n,) + rays_d_cam.shape))


def expand_ray_directions(ray_directions: torch.Tensor, num_steps: int) -> torch.Tensor:
    """(B, rays, 3) -> (B, rays*steps, 3)."""
    B, R, _ = ray_directions.shape
    return ray_directions[:, :, None, :].expand(B, R, num_steps, 3).reshape(B, R * num_steps, 3)


def perturb_points(points, z_vals, ray_directions, generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None):
    """Uniform per-sample jitter within one step interval: ``u`` (uniform
    on [0, 1), z_vals' shape) or a draw from ``generator``."""
    dist = z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :]
    if u is None:
        u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
    offset = (u - 0.5) * dist
    return points + offset * ray_directions[:, :, None, :], z_vals + offset


def _truncated_normal(shape, generator, device):
    """Standard normal truncated to [-2, 2] by the inverse CDF, as
    ``jax.random.truncated_normal``."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo
    return torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)


def sample_camera_positions(n: int = 1, r: float = 1.0, horizontal_stddev: float = 1.0,
                            vertical_stddev: float = 1.0,
                            horizontal_mean: float = math.pi * 0.5,
                            vertical_mean: float = math.pi * 0.5, mode: str = "normal",
                            generator: Optional[torch.Generator] = None, device=None):
    """Camera positions on a sphere of radius ``r`` (JAX
    ``sample_camera_positions``); theta = yaw, phi = pitch.  Modes:
    'uniform', 'normal'/'gaussian', 'hybrid' (one coin for the whole batch
    picks uniform at twice the spread or normal), 'truncated_gaussian'
    (normal cut at two standard deviations), 'spherical_uniform' (phi
    uniform in cos), anything else the means.  Returns (origin (n, 3),
    phi (n, 1), theta (n, 1))."""
    rand = lambda: torch.rand(n, 1, generator=generator, device=device)
    randn = lambda: torch.randn(n, 1, generator=generator, device=device)
    hs, vs, hm, vm = horizontal_stddev, vertical_stddev, horizontal_mean, vertical_mean
    if mode == "hybrid":
        coin = torch.rand((), generator=generator, device=device) < 0.5
        mode = "hybrid_uniform" if bool(coin) else "normal"
    if mode == "uniform":
        theta, phi = (rand() - 0.5) * 2 * hs + hm, (rand() - 0.5) * 2 * vs + vm
    elif mode == "hybrid_uniform":
        theta, phi = (rand() - 0.5) * 4 * hs + hm, (rand() - 0.5) * 4 * vs + vm
    elif mode in ("normal", "gaussian"):
        theta, phi = randn() * hs + hm, randn() * vs + vm
    elif mode == "truncated_gaussian":
        theta = _truncated_normal((n, 1), generator, device) * hs + hm
        phi = _truncated_normal((n, 1), generator, device) * vs + vm
    elif mode == "spherical_uniform":
        theta = (2.0 * rand() - 1.0) * hs + hm
        v = (2.0 * rand() - 1.0) * (vs / math.pi) + vm / math.pi
        phi = torch.arccos(1 - 2 * torch.clamp(v, 1e-5, 1 - 1e-5))
    else:
        theta = torch.full((n, 1), hm, dtype=torch.float32, device=device)
        phi = torch.full((n, 1), vm, dtype=torch.float32, device=device)
    phi = torch.clamp(phi, 1e-5, math.pi - 1e-5)
    origin = torch.cat([r * torch.sin(phi) * torch.cos(theta), r * torch.cos(phi),
                        r * torch.sin(phi) * torch.sin(theta)], -1)
    return origin, phi, theta


def create_cam2world_matrix(forward_vector: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Look-at cam2world (B, 4, 4), y up."""
    forward_vector = normalize_vecs(forward_vector)
    up = forward_vector.new_tensor([0.0, 1.0, 0.0]).expand(forward_vector.shape)
    left = normalize_vecs(torch.cross(up, forward_vector, dim=-1))
    up = normalize_vecs(torch.cross(forward_vector, left, dim=-1))
    B = forward_vector.shape[0]
    cam2world = torch.eye(4, dtype=forward_vector.dtype,
                          device=forward_vector.device).repeat(B, 1, 1)
    cam2world[:, :3, :3] = torch.stack([left, up, forward_vector], -1)
    cam2world[:, :3, 3] = origin
    return cam2world


def transform_sampled_points(points, z_vals, ray_directions,
                             cam2world_matrix: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             perturb: bool = False, perturb_u: Optional[torch.Tensor] = None,
                             mode: Optional[str] = "normal", h_stddev: float = 1.0,
                             v_stddev: float = 1.0, h_mean: float = math.pi * 0.5,
                             v_mean: float = math.pi * 0.5):
    """Jitter samples (``perturb``: ``perturb_u`` or a draw from
    ``generator``) and map camera space to world through
    ``cam2world_matrix``.  Without a cam2world it samples a camera
    (``sample_camera_positions`` at ``mode`` and the h/v spreads, looking at
    the origin).  Returns (points (B, R, S, 3), z_vals, dirs (B, R, 3), ray
    origins (B, R, 3)).  The JAX function also returns the sampled pitch,
    yaw and world2cam, which no caller reads, and takes canonical matrices,
    which no caller passes."""
    B, R, S, _ = points.shape
    if perturb:
        points, z_vals = perturb_points(points, z_vals, ray_directions, generator, perturb_u)
    if cam2world_matrix is None:
        origin, _, _ = sample_camera_positions(B, 1.0, h_stddev, v_stddev, h_mean, v_mean,
                                               mode if mode is not None else "none", generator,
                                               points.device)
        cam2world_matrix = create_cam2world_matrix(normalize_vecs(-origin), origin)
    compose = cam2world_matrix.float()
    rot, trans = compose[:, :3, :3], compose[:, :3, 3]
    pts = torch.einsum("bij,bnj->bni", rot, points.reshape(B, R * S, 3)) + trans[:, None]
    dirs = torch.einsum("bij,bnj->bni", rot, ray_directions)
    return pts.reshape(B, R, S, 3), z_vals, dirs, trans[:, None].expand(B, R, 3)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
               det: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling for hierarchical NeRF (JAX
    ``sample_pdf``).  bins (N, M+1), weights (N, M) -> samples (N, n_importance),
    at ``u`` (uniform on [0, 1), (N, n_importance)), evenly spaced with
    ``det``, or at a draw from ``generator``.  ``torch.searchsorted`` with
    ``right=False`` is ``jnp.searchsorted``'s left side."""
    n_rays, n_samples = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1).contiguous()
    if det:
        u = torch.linspace(0.0, 1.0, n_importance, device=bins.device).expand(n_rays, n_importance)
    elif u is None:
        u = torch.rand(n_rays, n_importance, generator=generator, device=bins.device)
    u = u.to(cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf, u, right=False)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_samples)
    cdf_below, cdf_above = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_below, bins_above = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)
