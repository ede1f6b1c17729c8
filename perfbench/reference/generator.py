"""The Map3D generator's eval forward, image by image, in plain PyTorch.

From a state dict in the model's torch key space (``neural_field.*``,
``synthesis_network.*`` ...) and a config, ``ReferenceGenerator.forward``
computes what the port's ``staged_forward`` returns at truncation 1 with the
draws handed in: the rays (weak-perspective, jittered by ``perturb``), the
31-d geo conditioning (brute-force 1-NN over the posed vertices), the
FiLM-SIREN field over every sample (unfolded: freq*15+30 and phase applied
per element, the polynomial sine where ``fast_math``), the nerf noise on
sigma, the alpha composite, the bilinear resize of the feature map and the
SPADE synthesis stack normalised by its running stats with frozen
spectral-norm ``u``.  Returns ``rgbs`` (B, H, W, 3), ``rgbs_render`` (B, h,
w, 3) and ``depths`` (B, h, w, 1).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Products

# degree-9 odd minimax sine on [-pi, pi] after a 2*pi range reduction
_SIN_C = (0.999979407588, -0.166624416001, 0.00830899784978, -0.000192651914745,
          2.14797007513e-06)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    k = torch.round(x * (0.5 / math.pi))
    y = x - k * (2.0 * math.pi)
    y2 = y * y
    c1, c3, c5, c7, c9 = _SIN_C
    return y * (c1 + y2 * (c3 + y2 * (c5 + y2 * (c7 + y2 * c9))))


def lrelu(x, alpha=0.2):
    return torch.where(x >= 0, x, alpha * x)


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


def normalize_vecs(v, eps=1e-12):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def ray_integration(field, z_vals, noise=None, noise_std=0.5, white_back=False):
    """Front-to-back alpha composite of (rays, S, C+1) samples, sigma last;
    ReLU density, delta 1e9 on the last step.  Returns (features (rays, C),
    depth (rays, 1))."""
    feats, sigma = field[..., :-1], field[..., -1:]
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, 1e9 * torch.ones_like(deltas[:, :1])], 1)
    if noise is not None:
        sigma = sigma + noise_std * noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigma))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-12], 1)
    weights = alphas * torch.cumprod(shifted, 1)[:, :-1]
    wsum = weights.sum(1)
    out = (weights * feats).sum(1)
    w_res = torch.cat([weights[:, :-1], weights[:, -1:] + (1.0 - wsum)[:, None]], 1)
    depth = (w_res * z_vals).sum(1)
    if white_back:
        out = out + 1.0 - wsum
    return out, depth


class ReferenceGenerator:
    def __init__(self, state: Dict[str, torch.Tensor], meta: Dict,
                 products: Products = Products()):
        self.s = {k: v.float() for k, v in state.items() if v.is_floating_point()}
        self.meta = meta
        self.p = products

    # -- building blocks -------------------------------------------------
    def linear(self, x, key):
        """torch Linear / 1x1 conv at ``key``: weight (out, in[, 1, 1])."""
        w = self.s[key + ".weight"]
        return self.p.mm(x, w.reshape(w.shape[0], -1).t()) + self.s[key + ".bias"]

    def mapping(self, z):
        """(freq, phase) of the field's mapping (of a zero latent unless
        ``neural_field_latent_input``) and the synthesis style row."""
        x = normalize_2nd_moment(z if self.meta.get("neural_field_latent_input", True)
                                 else torch.zeros_like(z))
        for i in range(4):
            x = self.linear(x, f"neural_field_mapping_network.network.{2 * i}")
            x = lrelu(x) if i < 3 else x
        freq, phase = x.chunk(2, -1)
        y = normalize_2nd_moment(z)

        def fc(y, key):  # equalised lr (lr multiplier 0.01), lrelu with gain sqrt(2)
            w = self.s[key + ".weight"]
            y = self.p.mm(y, (w * (0.01 / math.sqrt(w.shape[1]))).t())
            return lrelu(y + self.s[key + ".bias"] * 0.01) * math.sqrt(2.0)

        for i in range(7):
            y = fc(y, f"synthesis_mapping_network.trunk{i}")
        return freq, phase, fc(y, "synthesis_mapping_network.superres0")

    def rays(self, cond, b, perturb):
        """World points (R*S, 3), depths (R, S, 1) of image ``b``."""
        m = self.meta
        W, H, S = m["render_width"], m["render_height"], m["num_steps"]
        dev = perturb.device
        focal = cond["intrinsics"][b, 0, 0].float()
        xs = torch.linspace(-W / H, W / H, W, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        d = normalize_vecs(torch.stack([gx.reshape(-1), gy.reshape(-1),
                                        focal.expand(H * W)], -1))
        z = (torch.linspace(m["ray_start"], m["ray_end"], S, device=dev)
             + focal / cond["scales"][b].float()).reshape(1, S, 1).expand(H * W, S, 1)
        pts = d[:, None, :] * z
        if m.get("perturb_rays", True):
            off = (perturb[b] - 0.5) * (z[:, 1:2] - z[:, 0:1])
            pts, z = pts + off * d[:, None, :], z + off
        c2w = cond["cam2world_matrices"][b].float()
        pts = pts.reshape(-1, 3) @ c2w[:3, :3].t() + c2w[:3, 3]
        return pts, z

    def geo(self, cond, b, pts, chunk=4096):
        """The 31-d conditioning of each point (legacy column order when
        ``legacy_mode``): joint distances / 2.4, the inverse-LBS
        canonical point of the nearest vertex, its T-pose, its distance."""
        verts = cond["vertices"][b].float()
        ik = torch.linalg.inv(cond["fk_matrices"][b].float())
        vik = torch.einsum("vj,jkl->vkl", cond["lbs_weights"][b].float(), ik).reshape(-1, 16)
        tpose = cond["tpose_vertices"][b].float()
        skel = cond["skeletons_xyz"][b].float()
        out = []
        for p0 in range(0, pts.shape[0], chunk):
            p = pts[p0:p0 + chunk]
            d = [(p[:, None, c] - verts[None, :, c]) ** 2 for c in range(3)]
            d2 = (d[0] + d[1]) + d[2]
            idx = torch.argmin(d2, 1)  # the lowest index on exact ties
            best = torch.gather(d2, 1, idx[:, None])[:, 0]
            jd = torch.sqrt(((p[:, None, :] - skel[None]) ** 2).sum(-1) + 1e-12) / 2.4
            g = vik[idx].reshape(-1, 4, 4)
            c = torch.einsum("pij,pj->pi", g, torch.cat([p, torch.ones_like(p[:, :1])], -1))
            cano = torch.stack([c[:, 0] / 2.0, (c[:, 1] + 0.2) / 2.0, c[:, 2] / 1.3], -1)
            tp = tpose[idx]
            tp = torch.stack([tp[:, 0], tp[:, 1], tp[:, 2] / 0.2], -1)
            nd = torch.sqrt(best)[:, None] / 1.3
            cols = ([jd, cano, tp, nd] if self.meta.get("legacy_mode", False)
                    else [cano, jd, tp, nd])
            out.append(torch.cat(cols, -1))
        return torch.cat(out, 0)

    def field(self, pts, geo, freq, phase, chunk=65536):
        """[rgb 3, features F, sigma 1] of each point (COORDCONCATSIREN)."""
        m = self.meta
        if not m.get("lock_view_dependence", False):
            raise ValueError("the reference field takes lock_view_dependence")
        sin = fast_sin if m.get("fast_math", True) else torch.sin
        H, NB = m["hidden_dim"], m["neural_field_blocks"]
        f = (freq * 15.0 + 30.0).reshape(NB, H)
        ph = phase.reshape(NB, H)
        dirs = torch.zeros(1, 3, device=pts.device)
        dirs[0, 2] = -1.0  # lock_view_dependence: every ray looks down -z
        key = "neural_field."
        out = []
        for p0 in range(0, pts.shape[0], chunk):
            p, g = pts[p0:p0 + chunk], geo[p0:p0 + chunk]
            x1 = sin(30.0 * self.linear(p * (2.0 / m["side_length"]),
                                        key + "first_layer_coord.layer"))
            x2 = sin(30.0 * self.linear(g, key + "first_layer_mod.layer"))
            x = torch.cat([x1, x2], -1)
            for i in range(NB):
                x = sin(f[i] * self.linear(x, f"{key}network.{i}.layer") + ph[i])
            sigma = self.linear(x, key + "sigma_layer")
            xc = torch.cat([dirs.expand(x.shape[0], 3), x], -1)
            xc = sin(f[-1] * self.linear(xc, key + "color_layer_sine.layer") + ph[-1])
            rgb = torch.sigmoid(self.linear(xc, key + "color_layer_linear"))
            out.append(torch.cat([rgb, self.linear(xc, key + "feature_layer_linear"), sigma], -1))
        return torch.cat(out, 0)

    def spade(self, x, style, key):
        """Batch-norm SPADE at running stats; ``style`` (P or 1, Cs)."""
        r = torch.rsqrt(self.s[key + ".first_norm.running_var"] + 1e-5)
        y = ((x - self.s[key + ".first_norm.running_mean"]) * r
             * self.s[key + ".first_norm.weight"] + self.s[key + ".first_norm.bias"])
        actv = torch.relu(self.linear(style, key + ".mlp_shared.0"))
        return y * (1.0 + self.linear(actv, key + ".mlp_gamma")) + self.linear(actv,
                                                                              key + ".mlp_beta")

    def sn_weight(self, key):
        """(in, out) weight over its spectral-norm estimate, ``u`` frozen."""
        w = self.s[key + ".weight_orig"][:, :, 0, 0].t()
        u = self.s[key + ".weight_u"]
        v = normalize_vecs(w @ u, 1e-12)
        return w / torch.dot(v, w @ u)

    def block_style(self, i, style_map, style_row):
        """Block ``i``'s style: the map (with the row added in 'mixed' and
        'all') on the mod blocks, else the row ('isolated', 'mixed')."""
        mode = self.meta.get("map3d_mode", "isolated")
        mod = i in self.meta["mod_blocks"]
        if mode == "all" or (mode == "mixed" and mod):
            return style_map + style_row
        if mode in ("mixed", "isolated"):
            return style_map if mod else style_row
        raise ValueError(f"map3d_mode {mode!r}")

    def synthesis(self, style_map, style_row, chunk=32768):
        """rgb (H*W, 3) of one image: the Fourier input, the SPADE blocks
        (``block_style``), skips on the second half, ToRGB from block
        NB//2-1."""
        m = self.meta
        if m.get("spatial_normalization", "batch_norm") != "batch_norm":
            raise ValueError("the reference synthesis takes batch norm")
        NB = m["synthesis_blocks"]
        Hh, Ww = m["gen_height"], m["gen_width"]
        dev = style_map.device
        gi, gj = torch.meshgrid(torch.linspace(-1.0, 1.0, Hh, device=dev),
                                torch.linspace(-1.0, 1.0, Ww, device=dev), indexing="ij")
        coords = torch.stack([gi, gj], -1).reshape(-1, 2)
        convs = {(i, c): self.sn_weight(f"synthesis_network.network.m3d_{i}.conv_{c}")
                 for i in range(NB) for c in (0, 1)}
        out = []
        for p0 in range(0, coords.shape[0], chunk):
            x = torch.sin(self.linear(coords[p0:p0 + chunk], "synthesis_input.network.0"))
            smap = style_map[p0:p0 + chunk]
            rgb = 0.0
            for i in range(NB):
                key = f"synthesis_network.network.m3d_{i}"
                st = self.block_style(i, smap, style_row)
                x0 = x
                for c in (0, 1):
                    h = lrelu(self.spade(x, st, f"{key}.spade_{c}"))
                    x = self.p.mm(h, convs[i, c]) + self.s[f"{key}.conv_{c}.bias"]
                if i >= NB // 2:
                    x = x + x0
                if i >= NB // 2 - 1:
                    rgb = rgb + self.linear(x, f"synthesis_network.to_rgbs.m3d_{i}.linear")
            out.append(rgb)
        return torch.cat(out, 0)

    # -- the forward ----------------------------------------------------
    @torch.no_grad()
    def forward(self, z, cond, draws) -> Dict[str, torch.Tensor]:
        m = self.meta
        B = z.shape[0]
        W, H, S = m["render_width"], m["render_height"], m["num_steps"]
        freq, phase, style_row = self.mapping(z.float())
        noise = draws.get("noise")
        rgbs, renders, depths = [], [], []
        for b in range(B):
            pts, zv = self.rays(cond, b, draws["perturb"])
            geo = self.geo(cond, b, pts)
            fo = self.field(pts, geo, freq[b], phase[b]).reshape(H * W, S, -1)
            nz = None if noise is None else noise[b].reshape(H * W, S, 1)
            o, d = ray_integration(fo, zv, nz, m.get("nerf_noise", 0.5),
                                   m.get("white_back", False))
            o = o.reshape(1, H, W, -1)
            renders.append(o[..., :3] * 2.0 - 1.0)
            focal = cond["intrinsics"][b, 0, 0].float()
            dd = (d - focal / cond["scales"][b].float()) / (m["depth_length"] / 2.0)
            depths.append(torch.clamp(dd, -1.0, 1.0).reshape(1, H, W, 1))
            fm = F.interpolate(o[..., 3:].permute(0, 3, 1, 2),
                               size=(m["gen_height"], m["gen_width"]), mode="bilinear",
                               align_corners=False, antialias=False)
            fm = fm.permute(0, 2, 3, 1).reshape(-1, fm.shape[1])
            rgbs.append(self.synthesis(fm, style_row[b:b + 1]).reshape(
                1, m["gen_height"], m["gen_width"], 3))
        return {"rgbs": torch.cat(rgbs), "rgbs_render": torch.cat(renders),
                "depths": torch.cat(depths)}
