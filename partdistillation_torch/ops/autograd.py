"""The contract of a kernel op: which version runs, how it is
differentiated, where its backward shows in a trace, and how its launches
are counted.

Every public kernel wrapper in ``ops/`` calls :func:`route` with its name
(one of ``OPS``), its plain version, its kernel launcher, its backward
launcher where it has one, its tensor inputs and its static arguments
(keywords: eps, scale, shapes, a band). The route decides, in
this order:

- under :func:`plain_versions` naming the op, or for CPU tensors: the plain
  version, differentiated by autograd;
- with no gradient recorded: the bare kernel launch;
- otherwise the kernel under ``KernelOp``, the one autograd Function
  (``KernelOpBackward`` in a trace). Its forward saves the inputs and, where
  the kernel returns more than its output, all that the kernel returns (the
  masked attention's output, log-sum-exp and effective mask). Its backward
  runs inside the span ``bwd.<name>`` (``utils/profiling.SPANS``): the
  backward launcher where there is one, asked for the gradients autograd
  needs, otherwise the VJP of the plain version recomputed from the saved
  inputs, as the JAX package's ``custom_vjp``s of its forward-only kernels.

A kernel launcher is called ``kernel(*inputs, **static)`` and returns the
output, or ``(output, *residuals)``; a backward launcher is called
``backward(grad, needs, *inputs, *returned, **static)``, ``returned`` what
the kernel returned when that was a tuple, and returns one gradient (or
None) per input.

The launchers count their launches in one table, keyed by ``LAUNCHES``:
:func:`launch_counts` reads it, :func:`reset_launches` zeroes it.
``chip_smoke.py`` and the tools hold each path's launches to it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

__all__ = ["route", "kernel_op", "KernelOp", "plain_versions", "OPS", "LAUNCHES", "count",
           "launch_counts", "reset_launches"]

# the routed ops: the names plain_versions takes, each backward's span bwd.<name>
OPS = ("layer_norm", "ln_mlp", "window_attn", "window_attn_proj", "masked_attn", "msda",
       "relpos_attn")
# the launch counters: a call of the wrapper or launcher each names counts one
LAUNCHES = ("layer_norm", "fused_ln_mlp", "fused_ln_mlp_backward", "fused_window_attention",
            "window_attention_proj", "fused_masked_attention", "fused_masked_attention_bwd",
            "msda_folded", "msda_folded_banded", "msda_folded_bwd", "msda_folded_bwd_banded",
            "msda_taps", "relpos_attention", "relpos_attention_bwd")

_launches = dict.fromkeys(LAUNCHES, 0)
_plain = frozenset()  # the ops plain_versions sends to their plain versions


def count(key: str) -> None:
    """One launch of ``key`` (one of ``LAUNCHES``)."""
    _launches[key] += 1


def launch_counts(*keys: str) -> dict:
    """The launches counted under ``keys`` (by default all of ``LAUNCHES``)
    since the last :func:`reset_launches`."""
    return {k: _launches[k] for k in keys or LAUNCHES}


def reset_launches() -> None:
    for k in _launches:
        _launches[k] = 0


@contextlib.contextmanager
def plain_versions(names=None):
    """Send the ops named in ``names`` (of ``OPS``; by default all) to their
    plain versions on every device while the context is open: a seam for
    tests and for comparing a kernel with its plain version on the card."""
    global _plain
    unknown = set(names or ()) - set(OPS)
    if unknown:
        raise ValueError(f"plain_versions: no op {sorted(unknown)} (ops: {OPS})")
    saved = _plain
    _plain = frozenset(OPS if names is None else saved | set(names))
    try:
        yield
    finally:
        _plain = saved


class _Op(NamedTuple):
    name: str
    plain: Callable
    kernel: Callable
    backward: Optional[Callable]
    static: dict


def route(name: str, plain: Callable, kernel: Callable, *inputs, backward=None, **static):
    """``name``'s result on ``inputs`` (tensors, None allowed past the
    first) with the ``static`` keywords: the plain version, the bare kernel
    launch or the kernel under ``KernelOp``, as the module docstring sets
    out."""
    if name in _plain or inputs[0].device.type == "cpu":
        return plain(*inputs, **static)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return KernelOp.apply(_Op(name, plain, kernel, backward, static), *inputs)
    out = kernel(*inputs, **static)
    return out[0] if isinstance(out, tuple) else out


def kernel_op(name: str, plain: Callable, kernel: Callable, *inputs, backward=None, **static):
    """The route's last case on any device: ``kernel`` under ``KernelOp``."""
    return KernelOp.apply(_Op(name, plain, kernel, backward, static), *inputs)


class KernelOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *inputs):
        out = op.kernel(*inputs, **op.static)
        returned = out if isinstance(out, tuple) else ()
        # the backward keeps neither the kernel nor, with a backward launcher, the plain version
        ctx.op = op._replace(kernel=None, plain=None if op.backward else op.plain)
        ctx.n_inputs = len(inputs)
        ctx.save_for_backward(*inputs, *returned)
        return returned[0] if returned else out

    @staticmethod
    def backward(ctx, grad):
        op, needs = ctx.op, ctx.needs_input_grad[1:]
        saved = ctx.saved_tensors
        with record_function(f"bwd.{op.name}"):
            if op.backward is not None:
                grads = op.backward(grad, needs, *saved, **op.static)
            else:
                grads = _plain_vjp(op, grad, needs, saved[:ctx.n_inputs])
        return (None, *grads)


def _plain_vjp(op: _Op, grad, needs, inputs) -> list:
    """The plain version's VJP at ``grad``, recomputed from ``inputs``."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = op.plain(*leaves, **op.static)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], grad))
    return [next(grads) if n else None for n in needs]
