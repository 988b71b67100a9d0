"""Build the CUDA kernels with ``nvcc`` at first use and bind them with
``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<digest>.so csrc/<name>.cu

The file name carries a digest of the flags, the source and the shared
headers, so an edited source is rebuilt and a stale library is never
loaded.  Kernels are built only from the sources in this package.
:func:`build` compiles all stale libraries in parallel (one ``nvcc`` each,
all started together); :func:`load` builds one if needed and opens it.
Nothing here runs at import time.
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

import torch

__all__ = ["CSRC", "BUILD_DIR", "KERNELS", "HEADERS", "NVCC_FLAGS",
           "SMEM_LIMIT_BYTES", "H100_SMS", "nvcc_path", "library_path",
           "build", "load", "check", "sm_count"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/kernels (src/repro_torch/kernels/_build.py -> parents[3])
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("simhash_codes", "lss_topk", "bucket_logits")
# every header a csrc/*.cu includes: each is part of every library's digest
HEADERS = ("bulk_copy.cuh", "simhash.cuh", "warp_reduce.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

SMEM_LIMIT_BYTES = 232_448   # shared memory one H100 block may use
H100_SMS = 132               # streaming multiprocessors of an H100 SXM

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``; raises when none exists."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile every stale library among ``names`` in parallel.

    Returns the seconds each compile took (0.0 for one already built).
    Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {n: 0.0 for n in names}
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, errors = {n: 0.0 for n in names}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Open ``name``'s library, building it first if it is stale."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, what: str, error_string) -> None:
    """Raise if a C entry returned a nonzero ``cudaError_t``
    (``error_string`` is the library's ``cudaGetErrorString`` binding)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({error_string(err).decode()})")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device: the launch plans size their grids by it."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
