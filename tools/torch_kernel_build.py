#!/usr/bin/env python3
"""Times the build of the port's CUDA kernels (``partdistillation_torch/csrc``)
two ways, each from nothing into its own directory under ``build/``:

  * ``parallel``: ``native_lib.build_library`` (one ``nvcc -c`` per source,
    all started together, then one link);
  * ``single``: one ``nvcc -shared`` call over every source.

Prints one JSON line with both times. Needs ``nvcc``; run from the repository
root: ``python3 tools/torch_kernel_build.py``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from partdistillation_torch.utils import native_lib  # noqa: E402


def main() -> int:
    base = ROOT / "build" / "torch_kernels_build_time"
    shutil.rmtree(base, ignore_errors=True)
    native_lib.BUILD_DIR = base / "parallel"
    t0 = time.perf_counter()
    native_lib.build_library()
    parallel_s = time.perf_counter() - t0

    (base / "single").mkdir(parents=True)
    cu, _ = native_lib._sources()
    t0 = time.perf_counter()
    subprocess.run([native_lib._nvcc(), *native_lib.NVCC_FLAGS, "-I", str(native_lib.CSRC_DIR),
                    "-shared", "-o", str(base / "single" / "lib.so"), *map(str, cu),
                    "-lcudart"], check=True)
    single_s = time.perf_counter() - t0
    shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"phase": "kernel_build", "sources": len(cu),
                      "parallel_s": parallel_s, "single_call_s": single_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
