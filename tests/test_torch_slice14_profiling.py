"""The port's profiling harness and its ``profile`` and ``doctor`` commands
on the CPU.

- ``trace_steps`` / ``summarize_trace`` on a CPU matmul step, as
  ``tests/test_profiling.py::test_trace_steps_and_summarize`` runs the JAX
  pair: host ops bucketed by the ``record_function`` scope open around them
  (ms a step: the same trace read with ``steps=1`` gives exactly twice
  ``steps=2``'s, to 1e-9), ``kind_filter`` and ``return_detail``;
- the device attribution, which only a card's trace exercises, on a Chrome
  trace written here: kernels go to the scopes open at their launch on any
  thread of the process (the backward's kernels launched from autograd's
  thread), cut to ``scope_depth``, unscoped ones to ``<op>``; host ops are
  ignored once device events exist (sums exact to 1e-12);
- ``profile --tiny --device cpu --steps 2 --num-queries 8 --top 5`` at 64^2:
  the JAX CLI's JSON keys, the trace written, and ``backbone``,
  ``transformer_decoder`` and ``backward`` among the scopes;
- ``doctor --device cpu`` reports ok and returns; ``doctor`` for ``cuda``
  on a machine without one reports the backend not ok and exits 2, as does
  a backend probe that outlives ``--backend-timeout``. These skip on a
  machine with a CUDA device, where the answers differ.
"""

import json

import pytest
import torch
from torch.profiler import record_function

from partdistillation_torch import run as pcli
from partdistillation_torch.utils.profiling import TRACE_SUFFIX, summarize_trace, trace_steps


def test_trace_steps_and_summarize(tmp_path):
    x = torch.ones(256, 256, requires_grad=True)

    def step():
        with record_function("forward"):
            y = (x @ x).relu().sum()
        with record_function("backward"):
            y.backward()
        (x.detach() * 2).sum()

    d = trace_steps(step, str(tmp_path / "tr"), steps=2)
    assert (tmp_path / "tr" / ("steps" + TRACE_SUFFIX)).exists()
    summary = summarize_trace(d, steps=2)
    assert summary and sum(summary.values()) > 0
    assert {"forward", "backward"} <= set(summary)
    assert list(summary.values()) == sorted(summary.values(), reverse=True)
    assert any(k.startswith("<aten::") for k in summary)  # the unscoped ops
    once = summarize_trace(d, steps=1)
    for k, v in summary.items():
        assert abs(once[k] - 2 * v) <= 1e-9, k
    mm, detail = summarize_trace(d, steps=2, kind_filter=("aten::matmul",), return_detail=True)
    assert set(mm) == {"forward"} and set(detail["forward"]) == {"aten::matmul"}


def _x(name, cat, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def test_summarize_attributes_kernels_to_their_launch_scopes(tmp_path):
    """One step of a card's trace in miniature: the main thread (tid 1)
    opens ``backbone``, ``outer/inner`` and ``backward``; the forward
    kernels are launched from the main thread, the backward's from
    autograd's thread (tid 2) while the caller waits inside ``backward``;
    one kernel is launched outside every scope."""
    events = [
        _x("backbone", "user_annotation", 7, 1, 0, 100, **{"External id": 1}),
        _x("outer", "user_annotation", 7, 1, 100, 100, **{"External id": 2}),
        _x("inner", "user_annotation", 7, 1, 120, 50, **{"External id": 3}),
        _x("backward", "user_annotation", 7, 1, 300, 200, **{"External id": 4}),
        _x("aten::mm", "cpu_op", 7, 1, 10, 20, **{"External id": 10}),
        _x("aten::add", "cpu_op", 7, 1, 130, 10, **{"External id": 11}),
        _x("aten::mm", "cpu_op", 7, 2, 320, 30, **{"External id": 12}),
        _x("aten::copy_", "cpu_op", 7, 1, 600, 10, **{"External id": 13}),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, 15, 2, correlation=100),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, 135, 2, correlation=101),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 2, 325, 2, correlation=102),
        _x("cudaMemcpyAsync", "cuda_runtime", 7, 1, 605, 2, correlation=103),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, 150, 2, correlation=104),
        # device events: pid/tid are the card's and its stream
        _x("gemm_kernel", "kernel", 0, 7, 40, 1000.0, correlation=100, **{"External id": 10}),
        _x("add_kernel", "kernel", 0, 7, 1100, 250.0, correlation=101, **{"External id": 11}),
        _x("gemm_kernel", "kernel", 0, 7, 1400, 3000.0, correlation=102,
           **{"External id": 12}),
        _x("Memcpy HtoD", "gpu_memcpy", 0, 7, 4500, 500.0, correlation=103,
           **{"External id": 13}),
        # launched from C++ inside ``inner`` with no op around it
        _x("pd_kernel", "kernel", 0, 7, 5000, 100.0, correlation=104, **{"External id": 3}),
    ]
    d = tmp_path / "tr"
    d.mkdir()
    (d / ("steps" + TRACE_SUFFIX)).write_text(json.dumps({"traceEvents": events}))
    summary, detail = summarize_trace(str(d), steps=2, return_detail=True)
    want = {"backward": 1.5, "backbone": 0.5, "<aten::copy_>": 0.25, "outer/inner": 0.175}
    assert list(summary) == list(want)
    for k, v in want.items():
        assert abs(summary[k] - v) <= 1e-12, (k, summary[k])
    assert detail["outer/inner"] == pytest.approx({"aten::add": 0.125, "pd_kernel": 0.05},
                                                  abs=1e-12)
    assert set(summarize_trace(str(d), steps=2, scope_depth=1)) == {
        "backward", "backbone", "<aten::copy_>", "outer"}
    assert summarize_trace(str(d), steps=2, kind_filter=("aten::mm",)) == pytest.approx(
        {"backward": 1.5, "backbone": 0.5}, abs=1e-12)


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads([line for line in out if line.startswith("{")][-1])


def test_profile_cli_tiny_cpu(tmp_path, capsys):
    pcli.main(["profile", "--tiny", "--device", "cpu", "--steps", "2", "--num-queries", "8",
               "--top", "5", "--set", "data.image_size=64", "data.batch_size=2",
               "data.mask_capacity=8", f"checkpoint_dir={tmp_path}/ckpt"])
    res = _last_json(capsys)
    assert set(res) == {"stage", "trace_dir", "total_ms_per_step", "top"}
    assert res["stage"] == "profile" and res["total_ms_per_step"] > 0
    assert res["trace_dir"] == f"{tmp_path}/ckpt/profile"
    assert len(res["top"]) == 5
    assert (tmp_path / "ckpt" / "profile" / ("steps" + TRACE_SUFFIX)).exists()
    scopes = summarize_trace(res["trace_dir"], steps=2)
    assert {"backbone", "pixel_decoder", "transformer_decoder", "backward", "optimizer"} \
        <= set(scopes)
    assert all(scopes[k] > 0 for k in ("backbone", "transformer_decoder", "backward"))


def _no_cuda_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the doctor's answers differ")


def test_doctor_cpu_ok(tmp_path, capsys):
    _no_cuda_here()
    pcli.main(["doctor", "--device", "cpu", "--backend-timeout", "120", "--set",
               f"paths.root={tmp_path}/pseudo", f"checkpoint_dir={tmp_path}/ckpt"])
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] is True and res["stage"] == "doctor"
    assert res["backend"] == {"ok": True, "platform": "cpu", "devices": 1,
                              "cuda_available": False}
    assert res["torch"]["version"] == torch.__version__
    assert res["pseudo_label_root"] == {"ok": True, "path": f"{tmp_path}/pseudo"}
    assert res["kernels"]["ok"] is True and res["kernels"]["needed"] is False
    assert res["host_codec"]["ok"] is True
    assert res["host_codec"]["library"] in res["kernel_build_dir"]["entries"]


@pytest.mark.parametrize("timeout", [120, 0], ids=["no-card", "probe-timeout"])
def test_doctor_cuda_without_card_exits_2(tmp_path, capsys, timeout):
    _no_cuda_here()
    with pytest.raises(SystemExit) as e:
        pcli.main(["doctor", "--backend-timeout", str(timeout), "--set",
                   f"paths.root={tmp_path}/pseudo"])
    assert e.value.code == 2
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] is False and res["backend"]["ok"] is False
    assert ("hung" in res["backend"]["error"]) == (timeout == 0)
    assert "ok" in res["kernels"]  # built where nvcc is, refused where it is not
    assert res["pseudo_label_root"]["ok"] is True
