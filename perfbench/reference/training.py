"""The training pair (a discriminator step, then a generator step) in plain
PyTorch, float32, from the raw inputs the benchmark hands the program.

``follow`` builds the weights from the seed (``weights.make_state``), works
out each batch again from the synthetic dataset's definition (item ``i``:
``np.random.RandomState(i)`` draws the pose, the shape, the latent, the
image and its segments, in that order; the loader's epoch order is
``RandomState(epoch)``'s shuffle), and runs ``steps`` pairs with the draws
the benchmark handed the program:

* the preprocessor: the fix-body camera orbit (``smpl.fix_body_camera``)
  and a dense z-buffer of the posed mesh through the render camera (the
  lowest face wins a tie), segments = the face's DensePose label + 2,
  background 1;
* the discriminator step: the generator's train forward under no-grad
  (batch moments in the synthesis, each spectral-norm ``u`` stepped), the
  discriminator on the reals and then the fakes (its ``u`` stepped each
  time), the balanced segmentation cross-entropy of the reals against the
  rasterized or annotated segments (rasterized on rotated slots, else by
  the coin) and of the fakes against class 0, global-norm clipping, Adam;
* the generator step: its train forward with gradients (the field by image
  and the synthesis by block under ``torch.utils.checkpoint``, which
  recomputes the same values), the discriminator on the fakes in train
  mode, the segmentation loss against the chosen segments, clipping, Adam
  with the five learning-rate groups, the EMA.

It returns what the comparison reads: each step's two losses, each leaf's
norm of the first clipped gradient, and each leaf's norm of the change
after ``steps`` pairs (parameters and EMA).  The configuration's losses
beyond the segmentation term (GAN, latent, perceptual, photometric, ADA,
dual discrimination, R1 on a compared slot) are refused, not followed.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import smpl as ref_smpl
from perfbench.reference.discriminator import (ReferenceDiscriminator, discriminator_leaves,
                                               lrelu, sn_weight)
from perfbench.reference.generator import ReferenceGenerator, ray_integration
from perfbench.reference.precision import Products
from perfbench.reference.weights import generator_leaves, make_state

G_LR_MUL = {"latent_pool": "appearance_codes_lr_mul",
            "neural_field_mapping_network": "mapping_net_lr_mul",
            "synthesis_mapping_network": None, "neural_field": "neural_field_lr_mul"}


def refuse_unfollowed(meta: Dict, phases: List[Dict]):
    """The reference follows the segmentation objective alone."""
    for key in ("gan_lambda", "latent_lambda", "photometric_lambda", "ada_interval"):
        if meta.get(key, 0):
            raise ValueError(f"the training reference does not follow {key}")
    if sum(meta.get("perceptual_lambda", [0])) or meta.get("dual_discrimination", False):
        raise ValueError("the training reference does not follow perceptual or dual terms")
    for ph in phases:
        if ph["gen_modal"] != "rgbs" or not ph["uncond"]:
            raise ValueError("the training reference follows unconditional rgb phases")
        if ph["do_r1"] and meta["r1_lambda"] > 0:
            raise ValueError("the training reference follows no R1 slot")
    if meta.get("spatial_normalization") != "batch_norm":
        raise ValueError("the training reference takes batch-norm SPADE")


# -- data -----------------------------------------------------------------------

def face_labels(num_faces: int, root: str) -> np.ndarray:
    """DensePose body-part label (0..23) of each SMPL face from the
    repository's ``datasets/densepose_data.json`` where it covers the mesh,
    else 24 height-ordered parts by face index."""
    path = os.path.join(root, "datasets", "densepose_data.json")
    if os.path.exists(path):
        with open(path) as f:
            dp = json.load(f)
        s2d = np.asarray(dp["smpl_faces_to_densepose_faces"], np.int64)
        if len(s2d) == num_faces:
            return np.asarray(dp["densepose_faces_to_labels"], np.int64)[s2d]
    return (np.arange(num_faces) * 24 // max(num_faces, 1)).astype(np.int64)


def batch_indices(n_items: int, B: int, k: int) -> np.ndarray:
    """The dataset indices of the ``k``-th batch of a run from step 0."""
    per_epoch = n_items // B
    epoch, j = divmod(k, per_epoch)
    order = np.arange(n_items)
    np.random.RandomState(epoch).shuffle(order)
    return order[j * B:(j + 1) * B]


def synthetic_batch(indices, smpl_arrays, meta, device) -> Dict[str, torch.Tensor]:
    """The conditions, images and annotated segments of the items."""
    J = smpl_arrays["J_regressor"].shape[0]
    H, W, L = meta["gen_height"], meta["gen_width"], meta["latent_dim"]
    aa, betas, images, segs = [], [], [], []
    for i in indices:
        rs = np.random.RandomState(int(i))
        aa.append(0.2 * rs.randn(J, 3).astype(np.float32))
        betas.append(0.5 * rs.randn(1, 10).astype(np.float32))
        rs.randn(L)  # the item's latent: read by no unconditional phase
        images.append(rs.uniform(-1, 1, (H, W, 3)).astype(np.float32))
        segs.append(rs.randint(1, meta.get("label_dim", 26), (H, W)))
    t = lambda a, dt=torch.float32: torch.as_tensor(np.stack(a), dtype=dt, device=device)
    cond = ref_smpl.pose_conditions(smpl_arrays, t(aa), t(betas)[:, 0], meta.get("joints"))
    cond["images"] = t(images)
    cond["body_segments"] = t(segs, torch.int64)
    return cond


def rasterize_segments(cond, faces, labels, H: int, W: int, band: int = 16):
    """(B, H, W) int64 segments of the posed mesh through the render camera:
    a dense z-buffer by bands of rows over the faces whose box meets the
    band."""
    verts = cond["vertices"].float()
    w2c = torch.linalg.inv(cond["cam2world_matrices"].float())
    focal = cond["intrinsics"][:, 0, 0].float()
    vc = torch.einsum("bij,bvj->bvi", w2c[:, :3, :3], verts) + w2c[:, None, :3, 3]
    scr = torch.stack([focal[:, None] * vc[..., 0] / vc[..., 2],
                       focal[:, None] * vc[..., 1] / vc[..., 2], vc[..., 2]], -1)
    dev = verts.device
    span = W / H
    xs = torch.linspace(-span, span, W, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, device=dev)
    out = torch.ones(verts.shape[0], H, W, dtype=torch.int64, device=dev)
    for b in range(verts.shape[0]):
        tri = scr[b][faces]  # (F, 3, 3)
        ymin, ymax = tri[..., 1].amin(1), tri[..., 1].amax(1)
        for r0 in range(0, H, band):
            py = ys[r0:r0 + band]
            sel = torch.nonzero((ymax >= py[0]) & (ymin <= py[-1]))[:, 0]
            if sel.numel() == 0:
                continue
            t = tri[sel]
            gy, gx = torch.meshgrid(py, xs, indexing="ij")
            px, pyy = gx.reshape(1, -1), gy.reshape(1, -1)
            a, bb, c = t[:, 0, :, None], t[:, 1, :, None], t[:, 2, :, None]
            v0x, v0y = bb[:, 0] - a[:, 0], bb[:, 1] - a[:, 1]
            v1x, v1y = c[:, 0] - a[:, 0], c[:, 1] - a[:, 1]
            den = v0x * v1y - v0y * v1x
            ok = den.abs() > 1e-9
            inv = torch.where(ok, 1.0 / torch.where(ok, den, torch.ones_like(den)),
                              torch.zeros_like(den))
            v2x, v2y = px - a[:, 0], pyy - a[:, 1]
            w1 = (v2x * v1y - v2y * v1x) * inv
            w2 = (v0x * v2y - v0y * v2x) * inv
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok
            z = torch.where(inside, w0 * a[:, 2] + w1 * bb[:, 2] + w2 * c[:, 2],
                            torch.full_like(w0, 1e10))
            zmin, best = z.min(0)  # the lowest selected face on a tie: sel is ascending
            seg = labels[sel[best]] + 2
            out[b, r0:r0 + band] = torch.where(zmin < 1e10, seg, 1).reshape(len(py), W)
    return out


# -- losses and the optimizer ---------------------------------------------------------

def segmentation_loss(logits, gt, label_dim: int):
    """Balanced per-pixel cross-entropy: each present foreground class
    weighted by (pixels * label_dim) / (its count * classes present * L),
    class 0 none;
    plain mean cross-entropy where no pixel is foreground."""
    L = logits.shape[-1]
    ce = -torch.gather(torch.log_softmax(logits.float(), -1), -1, gt[..., None])[..., 0]
    occ = torch.bincount(gt.reshape(-1), minlength=label_dim).float()
    occ[0] = 0.0
    n_occ = (occ > 0).sum()
    total = float(gt.numel() * label_dim)  # the one-hot map's size
    coeff = torch.where(occ > 0, total / (occ.clamp(min=1e-12) * n_occ.clamp(min=1) * L),
                        torch.zeros_like(occ))
    coeff[0] = 0.0
    if bool((gt > 0).any()):
        return (ce * coeff[gt]).mean()
    return ce.mean()


class Adam:
    """torch.optim.Adam's update (no weight decay) with global-norm
    clipping before it and a learning-rate multiplier a leaf."""

    def __init__(self, params: Dict[str, torch.Tensor], betas, lr_mul: Dict[str, float],
                 eps: float = 1e-8):
        self.params, self.b1, self.b2, self.eps = params, float(betas[0]), float(betas[1]), eps
        self.lr_mul = lr_mul
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float, clip: float):
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
        factor = torch.clamp(clip / (norm + 1e-6), max=1.0) if clip > 0 else 1.0
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k] * factor
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr * self.lr_mul[k] / bc1)


# -- the generator's train forward ----------------------------------------------------

class TrainGenerator(ReferenceGenerator):
    """The generator's train forward over a batch (``ReferenceGenerator``'s
    blocks; batch moments in the synthesis, ``u`` stepped once a forward)."""

    def field_render(self, cond, b, pts, zv, geo, freq, phase, noise, noise_std):
        m = self.meta
        R = m["render_width"] * m["render_height"]
        fo = self.field(pts, geo, freq, phase).reshape(R, m["num_steps"], -1)
        o, _ = ray_integration(fo, zv, noise, noise_std, m.get("white_back", False))
        return o

    def synthesis_train(self, fm, style_row, grad: bool):
        """rgb (B, P, 3) of feature maps (B, P, F) and style rows (B, C)."""
        m = self.meta
        NB = m["synthesis_blocks"]
        Hh, Ww = m["gen_height"], m["gen_width"]
        dev = fm.device
        gi, gj = torch.meshgrid(torch.linspace(-1.0, 1.0, Hh, device=dev),
                                torch.linspace(-1.0, 1.0, Ww, device=dev), indexing="ij")
        coords = torch.stack([gi, gj], -1).reshape(1, -1, 2)
        x = torch.sin(self.linear(coords, "synthesis_input.network.0")).expand(
            fm.shape[0], -1, -1)
        convs = {}
        for i in range(NB):
            for c in (0, 1):
                key = f"synthesis_network.network.m3d_{i}.conv_{c}"
                convs[i, c] = sn_weight(self.s[key + ".weight_orig"], self.s[key + ".weight_u"],
                                        True)[:, :, 0, 0].t()
        rgb = torch.zeros(fm.shape[0], fm.shape[1], 3, device=dev)
        for i in range(NB):
            fn = lambda x, rgb, fm, row, w0, w1, i=i: self.block_train(i, x, rgb, fm, row, w0,
                                                                       w1)
            args = (x, rgb, fm, style_row, convs[i, 0], convs[i, 1])
            x, rgb = checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args)
        return rgb

    def block_train(self, i, x, rgb, fm, row, w0, w1):
        m = self.meta
        NB = m["synthesis_blocks"]
        key = f"synthesis_network.network.m3d_{i}"
        mode, mod = m.get("map3d_mode", "isolated"), i in m["mod_blocks"]
        if mode == "all" or (mode == "mixed" and mod):
            st = fm + row[:, None, :]
        elif mode in ("mixed", "isolated"):
            st = fm if mod else row[:, None, :]
        else:
            raise ValueError(f"map3d_mode {mode!r}")
        x0 = x
        for c, w in ((0, w0), (1, w1)):
            sp = f"{key}.spade_{c}"
            mean = x.mean((0, 1))
            var = torch.square(x - mean).mean((0, 1))
            y = ((x - mean) * torch.rsqrt(var + 1e-5) * self.s[sp + ".first_norm.weight"]
                 + self.s[sp + ".first_norm.bias"])
            actv = torch.relu(self.linear(st, sp + ".mlp_shared.0"))
            y = y * (1.0 + self.linear(actv, sp + ".mlp_gamma")) + self.linear(actv,
                                                                               sp + ".mlp_beta")
            x = self.p.mm(lrelu(y), w) + self.s[f"{key}.conv_{c}.bias"]
        if i >= NB // 2:
            x = x + x0
        if i >= NB // 2 - 1:
            rgb = rgb + self.linear(x, f"synthesis_network.to_rgbs.m3d_{i}.linear")
        return x, rgb

    def train_forward(self, z, cond, draws, noise_std, grad: bool):
        """rgbs (B, H, W, 3) of the train forward."""
        m = self.meta
        B = z.shape[0]
        W, H, S = m["render_width"], m["render_height"], m["num_steps"]
        gh, gw = m["gen_height"], m["gen_width"]
        freq, phase, style_row = self.mapping(z.float())
        feats = []
        for b in range(B):
            with torch.no_grad():
                pts, zv = self.rays(cond, b, draws["perturb"])
                geo = self.geo(cond, b, pts)
            noise = draws["noise"][b].reshape(H * W, S, 1)
            args = (cond, b, pts, zv, geo, freq[b], phase[b], noise, noise_std)
            o = (checkpoint(self.field_render, *args, use_reentrant=False) if grad
                 else self.field_render(*args))
            fm = F.interpolate(o[:, 3:].reshape(1, H, W, -1).permute(0, 3, 1, 2),
                               size=(gh, gw), mode="bilinear", align_corners=False,
                               antialias=False)
            feats.append(fm.permute(0, 2, 3, 1).reshape(1, gh * gw, -1))
        rgb = self.synthesis_train(torch.cat(feats), style_row, grad)
        return rgb.reshape(B, gh, gw, 3)


# -- the pair ----------------------------------------------------------------------

def split_state(state: Dict[str, torch.Tensor]):
    """(parameters as float32 leaves, buffers): buffers are the
    spectral-norm ``u`` and the batch norms' running state."""
    params, bufs = {}, {}
    for k, v in state.items():
        if k.endswith("weight_u") or ".running_" in k or k.endswith("num_batches_tracked"):
            bufs[k] = v.clone()
        else:
            params[k] = v.detach().float().clone().requires_grad_(True)
    return params, bufs


class ReferenceTrainer:
    def __init__(self, meta, g_state, d_state, smpl_arrays, labels, products=Products()):
        self.meta = meta
        self.gp, self.gb = split_state(g_state)
        self.dp, self.du = split_state(d_state)
        self.G = TrainGenerator({**self.gp, **self.gb}, meta, products)
        self.D = ReferenceDiscriminator(self.dp, self.du, meta, products)
        self.smpl, self.faces = smpl_arrays, None
        self.labels = labels
        betas = meta["betas"]

        def mul(leaf):
            key = G_LR_MUL.get(leaf.split(".")[0])
            return meta.get(key, 1.0) if key else 1.0

        self.opt_g = Adam(self.gp, betas, {k: mul(k) for k in self.gp})
        self.opt_d = Adam(self.dp, betas, {k: 1.0 for k in self.dp})
        self.ema = {k: p.detach().clone() for k, p in self.gp.items()}
        self.ema_count = 0

    def preprocess(self, batch, h, v):
        m = self.meta
        cond = dict(batch)
        cond["cam2world_matrices"] = ref_smpl.fix_body_camera(cond, h, v)
        if self.faces is None:
            self.faces = torch.as_tensor(self.smpl["faces"], device=h.device)
            self.labels = torch.as_tensor(self.labels, device=h.device)
        cond["rasterized_segments"] = rasterize_segments(cond, self.faces, self.labels,
                                                         m["gen_height"], m["gen_width"])
        return cond

    def segments(self, cond, coin, rotate: bool):
        if rotate or float(coin) < 0.5:
            return cond["rasterized_segments"]
        return cond["body_segments"]

    def d_step(self, batch, dr, phase, lr, noise_std):
        m = self.meta
        cond = self.preprocess(batch, dr["h_rotation"], dr["v_rotation"])
        with torch.no_grad():
            fake = self.G.train_forward(dr["z"], cond, dr, noise_std, grad=False)
        real_seg = self.segments(cond, dr["coin"], phase["rotate"])
        out_real = self.D.forward(cond["images"], train=True)
        out_fake = self.D.forward(fake, train=True)
        ld = m["label_dim"]
        loss = m["segmentation_lambda"] * (
            segmentation_loss(out_real["segments"], real_seg, ld)
            + segmentation_loss(out_fake["segments"], torch.zeros_like(real_seg), ld))
        grads = torch.autograd.grad(loss, list(self.dp.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.dp.items(), grads)}
        self.opt_d.step(grads, lr, m.get("grad_clip", 0.0))
        return float(loss.detach())

    def g_step(self, batch, dr, phase, lr, noise_std):
        m = self.meta
        cond = self.preprocess(batch, dr["h_rotation"], dr["v_rotation"])
        gt = self.segments(cond, dr["coin"], phase["rotate"])
        fake = self.G.train_forward(dr["z"], cond, dr, noise_std, grad=True)
        out = self.D.forward(fake, train=True)
        loss = m["segmentation_lambda"] * segmentation_loss(out["segments"], gt, m["label_dim"])
        grads = torch.autograd.grad(loss, list(self.gp.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.gp.items(), grads)}
        self.opt_g.step(grads, lr, m.get("grad_clip", 0.0))
        with torch.no_grad():
            self.ema_count += 1
            n = self.ema_count
            d = min(0.999, (1.0 + n) / (10.0 + n))
            for k, p in self.gp.items():
                self.ema[k].sub_((1.0 - d) * (self.ema[k] - p))
        return float(loss.detach())


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(t.detach().float())) for k, t in tensors.items()}


def follow(meta: Dict, phases: List[Dict], g_state, d_state, smpl_arrays, labels, batches,
           draws: List[Dict], lrs: List, steps: int, products: Products = Products(),
           half: bool = False) -> Dict:
    """Run ``steps`` pairs; returns {'losses': [[d, g] a step], 'grad':
    {'D'|'G': {leaf: norm of the first clipped gradient}}, 'change':
    {'D'|'G'|'EMA': {leaf: norm of the change after the steps}}}.
    ``batches(k)`` is pair k's batch; ``draws[k]`` its {'d', 'g'} draws;
    ``lrs[k]`` its (lr_g, lr_d, nerf_noise).  ``half`` leaves out the
    second half of every batch (a fault, for the limits)."""
    refuse_unfollowed(meta, phases[:steps])
    tr = ReferenceTrainer(meta, g_state, d_state, smpl_arrays, labels, products)
    p0 = {"D": {k: p.detach().clone() for k, p in tr.dp.items()},
          "G": {k: p.detach().clone() for k, p in tr.gp.items()}}
    losses, grad = [], {}
    for k in range(steps):
        batch, dr = batches(k), draws[k]
        if half:
            n = batch["images"].shape[0] // 2
            batch = {key: t[:n] for key, t in batch.items()}
            dr = {part: {key: t if t.ndim == 0 else t[:n] for key, t in d.items()}
                  for part, d in dr.items()}
        lr_g, lr_d, noise_std = lrs[k]
        phase = phases[k % len(phases)]
        ld = tr.d_step(batch, dr["d"], phase, lr_d, noise_std)
        lg = tr.g_step(batch, dr["g"], phase, lr_g, noise_std)
        losses.append([ld, lg])
        if k == 0:
            grad = {"D": leaf_norms(tr.opt_d.m), "G": leaf_norms(tr.opt_g.m)}
    change = {"D": leaf_norms({k: p - p0["D"][k] for k, p in tr.dp.items()}),
              "G": leaf_norms({k: p - p0["G"][k] for k, p in tr.gp.items()}),
              "EMA": leaf_norms({k: e - p0["G"][k] for k, e in tr.ema.items()})}
    return {"losses": losses, "grad": grad, "change": change}


def weights(meta: Dict, generator: torch.Generator, device):
    """(generator state, discriminator state) from one generator on ``device``."""
    return (make_state(generator_leaves(meta), generator, device),
            make_state(discriminator_leaves(meta), generator, device))
