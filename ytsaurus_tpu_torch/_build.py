"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is a file with a plain C interface. At first use it is
compiled for Hopper (`sm_90a`) into a shared library under `_build/`, named
by a hash of its source and flags, so a changed source builds anew and an
unchanged one is loaded as it is. Nothing is built when the package is
imported: the CPU, where there is no nvcc, never reaches this module's
`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, with ptxas's register and memory report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise YtError("nvcc was not found: the CUDA kernels of ytsaurus_tpu_torch "
                  "build only where the CUDA toolkit is installed",
                  code=EErrorCode.InvalidConfig)


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, building it first
    if this source has not been built yet."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if out.exists():
            build_info[name] = {"seconds": 0.0, "log": ""}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise YtError(f"nvcc failed to build {name}.cu:\n"
                              f"{proc.stdout}{proc.stderr}",
                              code=EErrorCode.InvalidConfig)
            os.replace(tmp, out)
            build_info[name] = {"seconds": seconds,
                                "log": proc.stdout + proc.stderr}
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
