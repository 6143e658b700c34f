"""The port's build of the native I/O library under concurrency: processes
that start together on an empty build directory (pytest-xdist workers
collecting at once) each load a complete library."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from multimodars_torch.io import native

REPO = Path(__file__).resolve().parents[1]

_LOADER = """
import os, sys, time
from pathlib import Path
from multimodars_torch.io import native
native.BUILD_DIR = Path(sys.argv[1])
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.005)
lib = native.get_library()
print("loaded" if lib is not None and hasattr(lib, "mm_finish_roll") else "missing")
"""


def test_six_processes_load_from_an_empty_build_directory(tmp_path):
    if native.get_library() is None:
        pytest.skip("the port's native library cannot be built here (no g++)")
    build = tmp_path / "build"
    go = tmp_path / "go"
    env = dict(os.environ)
    env.pop("MMTPU_NATIVE_BUILD", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _LOADER, str(build), str(go)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    time.sleep(3.0)  # every process imported the package and waits on `go`
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["loaded"] * 6
    # one library, built once; no temporary file left behind
    assert sorted(p.name for p in build.iterdir()) == [
        "libmmio.lock", native.library_path().name
    ]
    assert sum("building native I/O library" in err for _, err in outs) == 1


def test_library_path_names_source_and_flags():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libmmio_") and path.suffix == ".so"
