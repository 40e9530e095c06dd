"""Build and load the port's CUDA kernels (``nums_tpu_torch/csrc``).

The sources are compiled by ``nvcc`` into one shared library with a plain
C interface, loaded with ``ctypes``. The library goes into
``nums_tpu_torch/_build/`` under a name that carries a hash of the
sources, their headers (``csrc/*.cuh``) and flags, so an edited source or
header rebuilds on its next use and an unchanged one loads at once.
Nothing is built when a module is imported: the first CUDA call builds,
and a machine without ``nvcc`` can import and run every CPU path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("gram.cu", "newton.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
BUILD_LOG = ""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's usual home, else PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "nums_tpu_torch are built from nums_tpu_torch/csrc at first use"
        )
    return found


def headers() -> tuple:
    """Every ``csrc/*.cuh``: the sources include them."""
    return tuple(sorted(p.name for p in CSRC_DIR.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + headers():
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libnums_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Writes to a temporary name and renames, so a reader never sees a
    half-written library. The compiler's output (with ``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept in
    ``BUILD_LOG``."""
    global BUILD_LOG
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC_DIR / name) for name in SOURCES]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    handle = ctypes.CDLL(str(build()))
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle.nums_gram_stage.argtypes = [
        ptr, ptr, ptr, ll, ll, ll, ll, i32, ptr,
    ]
    handle.nums_gram_stage.restype = i32
    handle.nums_gram_staged.argtypes = [ptr, ptr, ptr, ll, ll, ll, i32, ptr]
    handle.nums_gram_staged.restype = i32
    for name in ("nums_gram_tile", "nums_gram_ktile"):
        getattr(handle, name).argtypes = []
        getattr(handle, name).restype = i32
    handle.nums_newton_stats.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ll, ll, i32, i32, ptr,
    ]
    handle.nums_newton_stats.restype = i32
    _lib = handle
    return _lib


def check(err: int, what: str):
    """Raise on a non-zero ``cudaGetLastError()`` from a launch; -1 is a
    TMA tensor map that ``cuTensorMapEncodeTiled`` refused."""
    if err == -1:
        raise RuntimeError(
            f"{what}: cuTensorMapEncodeTiled refused the TMA tensor map"
        )
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
