"""The route every kernel op of the port takes (``ops/autograd.route``), on
the CPU, over the nine public wrappers:

- CPU tensors: the wrapper's output and gradients are its plain version's
  bit for bit, no op reaches the autograd Function and no launch is counted;
- meta tensors (a device no kernel takes, so a stand-in for the card's)
  with a gradient recorded: the op reaches ``KernelOp`` under its own name
  (one of ``OPS``), unless ``plain_versions`` names it or names none, which
  sends it to its plain version whatever the device;
- ``KernelOp`` with a backward launcher saves what the kernel returns and
  hands it back; the launch table counts, reads and resets by key; an
  unknown name in the swap raises.
"""

import pytest
import torch

from partdistillation_torch.ops import autograd as ag
from partdistillation_torch.ops import fused_attention as fa
from partdistillation_torch.ops import fused_mlp as fm
from partdistillation_torch.ops import layer_norm as ln
from partdistillation_torch.ops import msda_sampling as ms
from partdistillation_torch.ops import relpos_attention as ra

SHAPES = ((2, 3), (1, 2))  # the deformable sampling's two levels, S = 8


def _inputs(device):
    """Per wrapper: (wrapper, its plain version, the tensor inputs, the
    static arguments), f32 with small shapes."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=g) * scale + offset).to(device)

    def unit(*shape):
        return torch.rand(shape, generator=g).to(device)

    mask = (torch.rand((1, 1, 4, 6), generator=g) < 0.5).to(device)
    return {
        "fused_layer_norm": (ln.fused_layer_norm, ln.layer_norm_plain,
                             (t(4, 8, scale=3.0), t(8), t(8)), {"eps": 1e-5}),
        "fused_ln_mlp": (fm.fused_ln_mlp, fm.ln_mlp_kernel_numerics,
                         (t(5, 16), t(16, offset=1.0), t(16), t(64, 16, scale=0.25), t(64),
                          t(16, 64, scale=0.125), t(16)), {"add_residual": False}),
        "fused_window_attention": (fa.fused_window_attention, fa.window_attention_plain,
                                   (t(2, 1, 8, 9), t(2, 1, 8, 9), t(2, 1, 8, 9), t(2, 1, 9, 9)),
                                   {"scale": 8 ** -0.5}),
        "fused_window_attention_proj": (
            fa.fused_window_attention_proj, fa.window_attention_proj_plain,
            (t(2, 1, 8, 9), t(2, 1, 8, 9), t(2, 1, 8, 9), t(1, 1, 9, 9), t(12, 8), t(12)),
            {"scale": 8 ** -0.5}),
        "fused_masked_attention": (fa.fused_masked_attention, fa.masked_attention_plain,
                                   (t(1, 2, 4, 8), t(1, 2, 6, 8), t(1, 2, 6, 8)),
                                   {"block_mask": mask}),
        "msda_folded": (lambda v, loc, a: ms.msda_folded(v, SHAPES, loc, a),
                        lambda v, loc, a: ms.msda_folded_plain(v, SHAPES, loc, a),
                        (t(1, 8, 2, 4), unit(1, 3, 2, 2, 2, 2), unit(1, 3, 2, 2, 2)), {}),
        "sample_level_folded": (ms.sample_level_folded, ms.sample_level_folded_plain,
                                (t(2, 6, 4), t(2, 2, 3, offset=1.0), t(2, 2, 3, offset=1.0),
                                 unit(2, 2, 3)), {"h": 2, "w": 3}),
        "sample_level": (ms.sample_level, ms.sample_level_plain,
                         (t(2, 3, 8), t(2, 5, offset=1.0), t(2, 5, offset=1.0), unit(2, 5)),
                         {"h": 2, "w": 3}),
        "relpos_attention": (ra.relpos_attention, ra.relpos_attention_plain,
                             (t(2, 12, 8), t(2, 12, 8), t(2, 12, 8), t(5, 8, scale=0.1),
                              t(7, 8, scale=0.1)), {"size": (3, 4), "scale": 8 ** -0.5}),
    }


def _refuse_function(monkeypatch, seen):
    def refuse(op, *inputs):
        seen.append(op.name)
        raise AssertionError(f"{op.name} reached KernelOp")

    monkeypatch.setattr(ag.KernelOp, "apply", refuse)


WRAPPERS = sorted(_inputs("cpu"))


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_route_is_the_plain_version(monkeypatch, name):
    fn, plain, inputs, static = _inputs("cpu")[name]
    seen = []
    _refuse_function(monkeypatch, seen)
    ag.reset_launches()
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = fn(*leaves, **static)
    ref_leaves = [x.clone().requires_grad_() for x in inputs]
    ref = plain(*ref_leaves, **static)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    for a, b in zip(torch.autograd.grad(out, leaves, g), torch.autograd.grad(ref, ref_leaves, g)):
        assert torch.equal(a, b)
    assert seen == [] and set(ag.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", WRAPPERS)
def test_swap_sends_every_device_to_the_plain_version(monkeypatch, name):
    fn, _, inputs, static = _inputs("meta")[name]
    seen = []
    _refuse_function(monkeypatch, seen)
    leaves = [x.requires_grad_() for x in inputs]
    with pytest.raises(AssertionError, match="reached KernelOp"):
        fn(*leaves, **static)
    (op,) = seen
    assert op in ag.OPS
    with ag.plain_versions(tuple(n for n in ag.OPS if n != op)):
        with pytest.raises(AssertionError, match="reached KernelOp"):
            fn(*leaves, **static)
    for names in (None, (op,)):
        with ag.plain_versions(names):
            out = fn(*leaves, **static)
        assert out.device.type == "meta" and type(out.grad_fn).__name__ != "KernelOpBackward"
    assert seen == [op, op]


def test_swap_nests_and_refuses_unknown_names():
    with ag.plain_versions(("msda",)):
        with ag.plain_versions(("ln_mlp",)):
            assert ag._plain == {"msda", "ln_mlp"}
        assert ag._plain == {"msda"}
    assert ag._plain == frozenset()
    with pytest.raises(ValueError, match="no op"):
        with ag.plain_versions(("msda_folded",)):
            pass
    assert ag._plain == frozenset()


def test_kernel_op_saves_what_the_kernel_returns():
    """A backward launcher gets the inputs, then the kernel's output and
    residuals, then the static arguments, and the needs of each input,
    inside the span ``bwd.<name>``."""
    seen = []

    def kernel(x, w, scale):
        out = torch.tanh(x @ w) * scale
        return out, out.detach() * 0 + 7.0

    def backward(grad, needs, x, w, out, residual, scale):
        seen.append((needs, torch.equal(residual, torch.full_like(out, 7.0)), scale))
        d = grad * scale * (1 - (out / scale) ** 2)
        return d @ w.t(), None

    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, generator=g, requires_grad=True)
    w = torch.randn(4, 4, generator=g)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ag.kernel_op("toy", None, kernel, x, w, scale=2.0, backward=backward)
        assert type(out.grad_fn).__name__ == "KernelOpBackward"
        (got,) = torch.autograd.grad(out.sum(), [x])
    assert seen == [((True, False), True, 2.0)]
    assert any(e.name == "bwd.toy" for e in prof.events())
    xr = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad((torch.tanh(xr @ w) * 2.0).sum(), [xr])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_launch_table_counts_reads_and_resets():
    ag.reset_launches()
    ag.count("msda_folded")
    ag.count("msda_folded")
    ag.count("msda_folded_banded")
    assert ag.launch_counts("msda_folded", "msda_folded_banded") == {
        "msda_folded": 2, "msda_folded_banded": 1}
    assert set(ag.launch_counts()) == set(ag.LAUNCHES)
    with pytest.raises(KeyError):
        ag.count("msda")
    ag.reset_launches()
    assert set(ag.launch_counts().values()) == {0}
