"""The port's discriminator runs channels-last from the input to the heads
(models/discriminator.py), so that cuDNN takes its NHWC tensor-core kernels.

A dispatch mode sees every ``aten.convolution`` and
``aten.convolution_backward`` through four passes at NANO sizes: the forward,
the backward to the parameters (the D step), the backward to the input (the
G step) and R1 (``trainers/losses.r1_regularization``: its forward, its
gradient w.r.t. the image, and the double backward to the parameters).

Every operand that D lays out is channels-last contiguous: each weight, each
forward convolution's input, and the input each weight gradient saved.  The
gradients that reach a convolution are channels-last too, dense or a channel
window of a channels-last gradient (``torch.cat``'s backward narrows; cuDNN
copies a window before it runs), but in R1's double backward, where the
derivatives of ``narrow`` and of ``avg_pool2d``'s backward write into NCHW
zeros.  No convolution runs on batch-transposed operands: the input's
gradient is ``conv_transpose2d``, whose derivative is cuDNN's own.  A
backward to the input alone frees what the convolutions saved."""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator, _upsample2x
from threedhumangan_tpu_torch.trainers import losses as L

CL = torch.channels_last
CONV, CONV_BWD = torch.ops.aten.convolution.default, torch.ops.aten.convolution_backward.default


def _channel_window(t):
    """NHWC strides with a pixel pitch of at least C: channels [a, b) of a
    channels-last tensor."""
    n, c, h, w = t.shape
    s = t.stride()
    return ((c == 1 or s[1] == 1) and (w == 1 or s[3] >= c)
            and (h == 1 or s[2] == s[3] * w) and (n == 1 or s[0] == s[2] * h))


def _layout(t):
    if t.is_contiguous(memory_format=CL):
        return "channels_last"
    if _channel_window(t):
        return "channel_window"
    if t.is_contiguous():
        return "nchw"
    return "other"


class _Convs(TorchDispatchMode):
    """(op, input, weight, grad_output) layouts of every convolution; a
    transposed convolution's input is a gradient."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is CONV:
            op = "conv_transpose" if args[6] else "conv"
            self.calls.append((op, _layout(args[0]), _layout(args[1]), None))
        elif func is CONV_BWD:
            op = "conv_transpose_bwd" if args[7] else "conv_bwd"
            self.calls.append((op, _layout(args[1]), _layout(args[2]), _layout(args[0])))
        return func(*args, **(kwargs or {}))


def _nano(gen_size, **kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(gen_height=gen_size[0], gen_width=gen_size[1], **kw)
    return meta


def _head_loss(out, seed):
    """A weighted sum of every head, so that each head's gradient is dense."""
    gen = torch.Generator().manual_seed(seed)
    return sum((v * torch.randn(v.shape, generator=gen)).sum() for v in out.values())


@pytest.mark.parametrize("gen_size,train,extra", [
    ((16, 8), True, {}), ((16, 8), False, {}), ((16, 16), True, {}), ((16, 16), False, {}),
    ((16, 8), True, {"dual_discrimination": True}), ((16, 16), False, {"semantic_dim": 3}),
], ids=["16x8-train", "16x8-eval", "16x16-train", "16x16-eval", "16x8-dual", "16x16-semantic"])
def test_discriminator_convolutions_are_channels_last(gen_size, train, extra):
    meta = _nano(gen_size, **extra)
    D = UNetDiscriminator(meta, torch.Generator().manual_seed(0))
    params = list(D.parameters())
    channels = 6 if extra.get("dual_discrimination") else 3
    img = torch.rand((2,) + gen_size + (channels,), generator=torch.Generator().manual_seed(1))
    img = (img * 2 - 1).requires_grad_(True)

    passes = {}
    with _Convs() as fwd:
        out = D(img, train=train)
    passes["forward"] = fwd.calls
    with _Convs() as bwd_params:
        torch.autograd.grad(_head_loss(out, 2), params, retain_graph=True, allow_unused=True)
    passes["backward_params"] = bwd_params.calls
    with _Convs() as bwd_input:
        (g_img,) = torch.autograd.grad(_head_loss(out, 3), img)
    passes["backward_input"] = bwd_input.calls
    assert g_img.shape == img.shape and torch.isfinite(g_img).all()
    with _Convs() as r1_first:
        r1 = L.r1_regularization(lambda x: D(x, train=False), img, 0.25, 0.0, 1.0)
    passes["r1_first_order"] = r1_first.calls
    with _Convs() as r1_double:
        grads = torch.autograd.grad(r1, params, allow_unused=True)
    passes["r1_double_backward"] = r1_double.calls
    assert any(g is not None for g in grads)

    tally = {k: collections.Counter(v) for k, v in passes.items()}
    print({k: dict(v) for k, v in tally.items()})
    latent_head = min(gen_size) > 2 ** len(D.down)  # a bottleneck wider than 1 x 1
    n_convs = sum(1 for m in D.modules() if type(m).__name__ == "Conv") - (not latent_head)
    ops = lambda name, op: sum(c[0] == op for c in passes[name])
    assert ops("forward", "conv") == len(passes["forward"]) == n_convs
    # each conv's input gradient (the image takes one here) and its weight
    # gradient, which the conv forms also where only the input's is asked
    # for; R1's scalar reads the segments alone
    m = n_convs - 1 - latent_head
    for name, op, count in (
            ("backward_params", "conv_transpose", n_convs),
            ("backward_params", "conv_bwd", n_convs),
            ("backward_input", "conv_transpose", n_convs),
            ("backward_input", "conv_bwd", n_convs),
            ("r1_first_order", "conv", n_convs), ("r1_first_order", "conv_transpose", m),
            ("r1_first_order", "conv_bwd", m), ("r1_double_backward", "conv_transpose_bwd", m),
            ("r1_double_backward", "conv_transpose", m), ("r1_double_backward", "conv_bwd", m)):
        assert ops(name, op) == count, (name, op)
    held = grads = nchw = 0
    for name, calls in passes.items():
        for op, x, w, g in calls:
            assert w == "channels_last", (name, op, x, w, g)
            held += 1
            if op in ("conv", "conv_bwd"):
                assert x == "channels_last", (name, op, x, w, g)
                held += 1
            # the gradients: a transposed conv's input and its backward's
            # saved input, and every backward's grad_output
            for t in ((x,) if op.startswith("conv_transpose") else ()) + ((g,) if g else ()):
                allowed = ("channels_last", "channel_window") + (
                    ("nchw",) if name == "r1_double_backward" else ())
                assert t in allowed, (name, op, x, w, g)
                grads += 1
                nchw += t == "nchw"
    print(f"channels-last: {held} of {held} weights and inputs; {grads} gradients, "
          f"{grads - nchw} NHWC, {nchw} NCHW in R1's double backward")
    # the heads come out NHWC-contiguous; with semantics, the two are channel
    # slices of one NHWC head
    assert out["prediction"].shape == (2,) + gen_size + (1,)
    assert out["prediction"].is_contiguous() and out["latents"].is_contiguous()
    head = D.output_layer.bias.shape[0]
    for k in ("segments", "semantics") if "semantic_dim" in extra else ("segments",):
        assert out[k].stride()[1:] == (gen_size[1] * head, head, 1), k
    if "semantic_dim" in extra:
        assert out["semantics"].shape == (2,) + gen_size + (extra["semantic_dim"],)


def _saved_activations(fn, batch):
    """Bytes of the batch's 4-D tensors that the graph under ``fn`` still
    holds (a node's saved tensors raise once its backward freed them)."""
    total, seen, stack = 0, set(), [fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        saved = []
        for name in dir(node):
            if name.startswith("_saved_") or name == "saved_tensors":
                try:
                    v = getattr(node, name)
                except RuntimeError:
                    continue
                saved += list(v) if isinstance(v, tuple) else [v]
        total += sum(t.untyped_storage().nbytes() for t in saved
                     if isinstance(t, torch.Tensor) and t.dim() == 4 and t.shape[0] == batch)
        stack += [f for f, _ in node.next_functions]
    return total


def test_backward_to_the_input_frees_the_activations():
    """The G step and R1's first pass ask for the input's gradient alone: each
    conv's backward runs and frees what it saved, as ``F.conv2d``'s does, so
    D's activations do not stay alive through G's backward."""
    D = UNetDiscriminator(_nano((16, 16)), torch.Generator().manual_seed(0))
    img = torch.rand(3, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    img = (img * 2 - 1).requires_grad_(True)
    loss = _head_loss(D(img), 6)
    assert _saved_activations(loss.grad_fn, 3) > 0
    torch.autograd.grad(loss, img)
    assert _saved_activations(loss.grad_fn, 3) == 0


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, CL], ids=["nchw", "nhwc"])
def test_upsample2x_is_bit_equal_to_repeat_interleave(memory_format):
    x = torch.randn(2, 5, 3, 4, generator=torch.Generator().manual_seed(4))
    x = x.contiguous(memory_format=memory_format)
    got = _upsample2x(x)
    assert torch.equal(got, x.repeat_interleave(2, 2).repeat_interleave(2, 3))
    assert got.is_contiguous(memory_format=memory_format)
    xb = x.to(torch.bfloat16)
    assert torch.equal(_upsample2x(xb), xb.repeat_interleave(2, 2).repeat_interleave(2, 3))
