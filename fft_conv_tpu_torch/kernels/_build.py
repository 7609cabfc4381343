"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) without PyTorch's headers, so a
build takes seconds. Libraries go to ``build/fft_conv_tpu_torch/`` at the
root of the checkout (``build/`` is git-ignored), named by a hash of the
source and the flags: an edited source is rebuilt at its next use and a
stale library is never loaded. Nothing is built when a module is imported;
``load`` builds on first use, ``build`` builds ahead of time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fft_conv_tpu_torch"
SOURCES = ("fused1d", "fused2d", "fused3d")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# nvcc's output (ptxas register and shared-memory report) of each library
# built by this process
build_logs: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the fused CUDA "
        "kernels are built from source with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compiles each named source that has no current library: one nvcc
    process per source, all started together and all waited for. Raises
    RuntimeError with nvcc's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
