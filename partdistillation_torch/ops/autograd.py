"""Gradients for the forward-only kernels (LayerNorm, window attention, the
one-level and per-tap deformable sampling): the forward is the kernel, the
backward the VJP of the kernel's plain version recomputed from the saved
inputs, as the JAX package's ``custom_vjp``s of the same functions do. The
JAX package has no backward kernel for them, and the port has none yet.
(The fused LN->MLP and the P-folded deformable sampling have backward
kernels of their own, ``ops/fused_mlp.py`` and ``ops/msda_sampling.py``; the
masked attention's backward is a kernel, as in the JAX package.) Every such backward shows in
a trace as ``_PlainVJPBackward``; the recomputation and its VJP run inside a
``bwd.<name>`` span (``utils/profiling.SPANS``) named by the caller."""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

__all__ = ["kernel_with_plain_vjp"]


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, span, *inputs):
        ctx.plain, ctx.span = plain, span
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with record_function(ctx.span), torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, needs) if n],
                                             grad))
        return (None, None, None, *[next(grads) if n else None for n in needs])


def kernel_with_plain_vjp(kernel: Callable, plain: Callable, *inputs: torch.Tensor,
                          name: str):
    """``kernel(*inputs)``, differentiable through ``plain`` when autograd
    records and an input requires a gradient; otherwise the bare launch.
    ``name``: the op's; its backward runs in the span ``bwd.<name>``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _PlainVJP.apply(kernel, plain, f"bwd.{name}", *inputs)
    return kernel(*inputs)
