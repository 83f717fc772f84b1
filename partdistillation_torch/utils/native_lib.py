"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a`` and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and flags, so a changed source always rebuilds. Nothing is built at
import time: the first kernel launch calls :func:`load_library`. A build or
load failure raises. Processes that start together (the ranks of one
``torchrun`` job) build once: the build holds an exclusive ``flock`` on a
file in the build directory, the library is looked for again once the lock
is held, and each building process names its object files by its pid, so none
links or deletes another's objects.

The host library (``csrc_host/*.cc``: the RLE codec and the CPU
MSDeformAttn) is built the same way by ``g++ -O3 -fopenmp -shared -fPIC``
into the same directory, under the same lock, at its first use
(:func:`load_host_library`); a failed build raises, naming ``g++``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_library", "build_library", "load_host_library", "build_host_library",
           "check", "BUILD_DIR", "CSRC_DIR", "HOST_SRC_DIR", "SM_COUNT"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
HOST_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc_host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
# SMs of the H100 the kernels target; the wrappers size their grids by it
SM_COUNT = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_S = ctypes.c_char_p
# C entry points: name -> argtypes (pointers and the stream as void*).
_SIGNATURES = {
    "pd_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "pd_fused_ln_mlp": [_P] * 10 + [_I, _I, _I, _F, _I, _I, _I, _P],
    "pd_window_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "pd_masked_attention": [_P] * 8 + [_I] * 9 + [_P],
    "pd_masked_attention_bwd": [_P] * 13 + [_I] * 10 + [_P],
    "pd_window_proj_attention": [_P] * 5 + [_I] * 7 + [_F, _P],
    "pd_window_proj_gemm": [_P] * 4 + [_I] * 4 + [_P],
    "pd_msda_folded": [_P] * 4 + [_I] * 7 + [_P, _I, _I, _I, _I, _P, _P],
    "pd_msda_taps": [_P] * 5 + [_I] * 7 + [_P],
}

# host entry points: name -> (argtypes, restype)
_HOST_SIGNATURES = {
    "pd_rle_encode": ([_P, _I64, _I64, _P, _I64], _I64),
    "pd_rle_decode": ([_S, _I64, _I64, _I64, _P], _I64),
    "pd_rle_area": ([_S, _I64], _I64),
    "pd_rle_iou_matrix": ([_S, _P, _I64, _S, _P, _I64, _P], None),
    "pd_ms_deform_attn_cpu": ([_P] * 4 + [_I64] * 7 + [_P], _I),
}

_lib = None
_host_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest(flags, files) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _locked_build(out: Path, build) -> Path:
    """``build(out)`` unless ``out`` exists, under the build directory's
    exclusive lock; returns ``out``."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process dies
        if not out.exists():  # built by another process while this one waited
            build(out)
    return out


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one ``.so``; returns
    its path (reused when the hash of sources and flags matches)."""
    cu, cuh = _sources()
    out = BUILD_DIR / f"libpd_kernels_{_digest(NVCC_FLAGS, cu + cuh)}.so"
    return _locked_build(out, lambda path: _build(path, verbose))


def _build(out: Path, verbose: bool) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}_{out.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors, logs = [], []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {src.name}\n{log}")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *[str(obj) for _, obj, _ in procs], "-lcudart"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)
    finally:
        for _, obj, _ in procs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("\n".join(logs))


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use and cached."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _host_sources():
    return sorted(HOST_SRC_DIR.glob("*.cc"))


def build_host_library() -> Path:
    """Compile ``csrc_host/*.cc`` with ``g++`` into one ``.so``; returns its
    path (reused when the hash of sources and flags matches)."""
    srcs = _host_sources()
    out = BUILD_DIR / f"libpd_host_{_digest(HOST_FLAGS, srcs)}.so"
    return _locked_build(out, lambda path: _build_host(path, srcs))


def _build_host(out: Path, srcs) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *HOST_FLAGS, *map(str, srcs), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found on PATH: the host library (the RLE codec, the CPU "
                           "MSDeformAttn) is built with it") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the host library:\n{proc.stdout}")
    os.replace(tmp, out)


def load_host_library() -> ctypes.CDLL:
    """The host library, built on first use and cached."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = ctypes.CDLL(str(build_host_library()))
            for name, (argtypes, restype) in _HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _host_lib = lib
    return _host_lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused etc.)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
