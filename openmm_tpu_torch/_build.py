"""Build and load the package's CUDA kernels.

All sources under csrc/ are compiled by ONE nvcc call into a shared library
with a plain C interface, loaded with ctypes: no PyTorch headers are
included, so the build takes seconds. The library lands in
build/openmm_tpu_torch/ beside the package, named by a hash of the sources;
a build writes a private temporary file and renames it into place, so no
lock file is ever read or written.

Each C entry point takes raw device pointers and the CUDA stream as
c_void_p, launches on that stream and returns cudaGetLastError(); the
Python wrappers check that code and raise on anything but 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "openmm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "omm_nonbonded_tiles": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P, _P],
    "omm_pme_spread": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "omm_pme_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    often its wrapper launched it (reset by callers that count a run)."""
    name: str
    source: str
    replaces: str
    launches: int = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME, install the CUDA toolkit under "
            "/usr/local/cuda, or put nvcc on PATH")
    return found


def library_path() -> Path:
    return BUILD_DIR / ("libomm_kernels-%s.so" % _source_hash())


def build(timeout: float = 600.0) -> tuple[Path, float, str]:
    """Compile the kernels if the library for these sources is missing.
    Returns (path, seconds spent in nvcc, nvcc's ptxas report). nvcc is
    killed after `timeout` seconds (subprocess.TimeoutExpired)."""
    path = library_path()
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *map(str, sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s%s" % (
                proc.returncode, proc.stdout, proc.stderr))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(code: int, kernel: Kernel) -> None:
    if code != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (kernel.name, code))
