"""Small math and precision helpers shared by the port's modules
(threedhumangan_tpu/utils/misc.py counterparts)."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point puts its tensors on: CUDA unless the caller
    names another.  Raises when CUDA is asked for and there is none, so no
    caller carries on on the CPU without having asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def mm(x: torch.Tensor, w: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``compute_dtype`` and the
    product accumulated in float32 — the JAX package's
    ``jnp.dot(..., preferred_element_type=f32)``.  A bf16 x bf16 product is
    exact in float32, so the float32 matmul of the rounded operands is that
    dot up to summation order (callers keep TF32 off)."""
    return torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


def normalize_vecs(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def round16(n: int) -> int:
    """n rounded up to a multiple of 16 (the bf16 tensor-core K/N step)."""
    return -(-n // 16) * 16


def pad_to(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``t`` cast to ``dtype`` and zero-padded at the end of each dim to ``shape``."""
    out = t.new_zeros(shape, dtype=dtype)
    out[tuple(slice(0, n) for n in t.shape)] = t.to(dtype)
    return out


def take_draw(draws, key: str, make):
    """``draws[key]`` where a caller handed that draw in, else ``make()``."""
    return make() if draws is None or key not in draws else draws[key]
