"""Build and load the port's CUDA kernels (``sipmask_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
at the root of the checkout, where the hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, and loaded with ``ctypes``. Nothing is
built when a module is imported, and nothing falls back: a missing ``nvcc``
or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the builds made by this process
BUILD_LOG: Dict[str, tuple] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default /usr/local/cuda), then
    PATH. Raises RuntimeError when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin or on PATH: the CUDA kernels of "
        "sipmask_tpu_torch are compiled from sipmask_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def _build(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary file and rename it, so that a concurrent
    # process never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG[name] = (time.perf_counter() - t0, res.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_build(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise on the cudaError_t a launcher returned."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer (an int,
    read without building a ``torch.cuda.Stream``: a few microseconds of a
    small kernel's host time)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def device_guard(device):
    """A context in which ``device`` is the current CUDA device, for a
    launch on its stream: a no-op when it already is, which spares the
    common case the cost of switching devices twice a call."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
