"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled
by nvcc, at first use, into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is rebuilt. Sources build in
parallel, one nvcc process each. Nothing here runs at import time: the
CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("corr_lookup", "encoder_stage")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> list[Path]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Raises with nvcc's stderr on failure."""
    targets = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in targets if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, path in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for name, path, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{err}")
            else:
                os.replace(tmp, path)
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return [p for _, p in targets]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
