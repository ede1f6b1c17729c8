"""The reference's products: operands rounded to one dtype, float32 sums."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded on its way back."""

    @staticmethod
    def forward(ctx, y, products):
        ctx.products = products
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.products.round(g), None


class Products:
    """``x @ w`` with both operands rounded to ``dtype`` and the sum in
    float32.  float32 leaves them as they are; float8 (e4m3) saturates at
    +-448 before it rounds, so a control run gives numbers, not NaN.  By
    default the rounding passes gradients through unchanged (the backward's
    products take the rounded operands and float32 gradients).  ``scaled``
    rounds each tensor at a scale that takes its largest magnitude to the
    dtype's largest (per-tensor scaling, as float8 training does);
    ``grads`` also rounds the gradient that reaches each product's output,
    so the backward's products take rounded operands on both sides."""

    def __init__(self, dtype=torch.float32, scaled: bool = False, grads: bool = False):
        self.dtype, self.scaled, self.grads = dtype, scaled, grads

    def round(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.dtype == torch.float32:
            return t
        top = FP8_MAX if self.dtype == torch.float8_e4m3fn else float(torch.finfo(self.dtype).max)
        with torch.no_grad():
            s = (t.detach().abs().amax().clamp(min=1e-30) / top) if self.scaled else None
        r = t.detach() if s is None else t.detach() / s
        if self.dtype == torch.float8_e4m3fn:
            r = r.clamp(-FP8_MAX, FP8_MAX)
        r = r.to(self.dtype).float()
        r = r if s is None else r * s
        return t + (r - t).detach() if t.requires_grad else r

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, its gradient rounded on the way back where
        ``grads``."""
        if self.grads and self.dtype != torch.float32 and y.requires_grad:
            return _RoundGrad.apply(y, self)
        return y

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.out(torch.matmul(self.round(x), self.round(w)))


def tf32_off():
    """The reference's float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
