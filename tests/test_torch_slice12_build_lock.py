"""The kernel library's build across processes (``utils/native_lib.py``).

The ranks of a ``torchrun`` job import the port together and each may reach
``build_library`` on a fresh checkout. With a fake ``nvcc`` (a script that
logs its arguments, sleeps and writes its ``-o``):

- two processes started together both return the same ``.so`` path, neither
  raises, and only one of them compiles and links (one ``-c`` per source and
  one link in the log);
- the object files are named per process: two builds one after the other
  (the library removed between them) write different object paths, and no
  object file is left behind.
"""

import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    echo "$@" >> "$NVCC_LOG"
    out=""
    prev=""
    for a in "$@"; do
        if [ "$prev" = "-o" ]; then out="$a"; fi
        prev="$a"
    done
    sleep 0.5
    echo built > "$out"
    """)

BUILD = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from partdistillation_torch.utils import native_lib
    native_lib.BUILD_DIR = Path(sys.argv[1])
    print(native_lib.build_library())
    """)


def _env(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
            "NVCC_LOG": str(tmp_path / "nvcc.log"), "PYTHONPATH": str(ROOT)}


def _start(tmp_path, env):
    return subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path / "build")], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err
    return out.strip()


def _log(tmp_path):
    return [line.split() for line in (tmp_path / "nvcc.log").read_text().splitlines()]


def _sources():
    return sorted((ROOT / "partdistillation_torch" / "csrc").glob("*.cu"))


def test_two_processes_build_once_and_load_one_library(tmp_path):
    env = _env(tmp_path)
    procs = [_start(tmp_path, env) for _ in range(2)]
    paths = [_finish(p) for p in procs]
    assert paths[0] == paths[1] and Path(paths[0]).read_text() == "built\n"
    calls = _log(tmp_path)
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == len(_sources()) and len(links) == 1
    # a third process finds the library and builds nothing
    assert _finish(_start(tmp_path, env)) == paths[0]
    assert len(_log(tmp_path)) == len(calls)


def test_object_files_are_named_per_process(tmp_path):
    env = _env(tmp_path)
    objects = []
    for _ in range(2):
        path = Path(_finish(_start(tmp_path, env)))
        objects.append({c[c.index("-o") + 1] for c in _log(tmp_path) if "-c" in c})
        path.unlink()
        (tmp_path / "nvcc.log").unlink()
    assert len(objects[0]) == len(objects[1]) == len(_sources())
    assert not objects[0] & objects[1]
    assert not list((tmp_path / "build").glob("*.o"))
