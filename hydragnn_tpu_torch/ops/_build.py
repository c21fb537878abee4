"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
compiles into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

at first use, into ``hydragnn_tpu_torch/_build/`` (listed in ``.gitignore``).
The file name carries a hash of the source, so an edited kernel is never
served from a stale build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its source and
    every header beside it (``csrc/*.cuh``, which the sources include)."""
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path, the compiler's output (``-Xptxas -v``: registers, spills;
    empty when nothing was built) and the wall seconds spent. Raises with
    the compiler's output if the build fails."""
    t0 = time.perf_counter()
    path = library_path(name)
    log = ""
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"kernel build failed: nvcc exited {proc.returncode}\n{log}")
        # Atomic publish: a concurrent loader sees the old state or the whole
        # library, never a half-written file.
        os.replace(tmp, path)
    return path, log, time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
