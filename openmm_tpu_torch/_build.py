"""Build and load the package's CUDA kernels.

Each source under csrc/ is compiled by an nvcc process of its own, all
started together, into an object file, and one more nvcc call links the
objects into a shared library with a plain C interface, loaded with
ctypes: no PyTorch headers are included, so the build takes seconds. The
library lands in build/openmm_tpu_torch/ beside the package, named by a
hash of the sources; a build writes into a private temporary directory
and renames the library into place, so no lock file is ever read or
written.

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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "openmm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "omm_nonbonded_tiles": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P],
    "omm_nonbonded_tiles_deriv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _P, _P, _P],
    "omm_pme_spread": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "omm_pme_gather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "omm_spread_triple_fwd": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P],
    "omm_spread_triple_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                              _P, _P, _P],
    "omm_graph_body_begin": [_P, _I, _P, _P, _P],
    "omm_graph_body_end": [_P, _I, ctypes.c_ulonglong, _P],
}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    often its wrapper launched it (reset by callers that count a run).
    Every Kernel is listed in KERNELS."""
    name: str
    source: str
    replaces: str
    launches: int = 0

    def __post_init__(self):
        KERNELS.append(self)


KERNELS: list[Kernel] = []


def fixed_accumulator(cells: int, device) -> torch.Tensor:
    """Scratch of csrc/fixed_scatter.cuh for a grid of `cells` cells: one
    int64 a cell and two more slots (the scale's max and a non-finite
    flag). The kernels zero it themselves."""
    return torch.empty(cells + 2, dtype=torch.int64, device=device)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    """Compile the kernels if the library for these sources is missing:
    one nvcc process a source, all at once, then one link. Returns (path,
    seconds spent in nvcc, nvcc's ptxas report). Every nvcc is killed
    after `timeout` seconds in all (subprocess.TimeoutExpired)."""
    path = library_path()
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objects)]
        logs = []
        try:
            for src, proc in zip(sources(), procs):
                left = max(timeout - (time.perf_counter() - t0), 0.1)
                out, _ = proc.communicate(timeout=left)
                logs.append(out)
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed on %s (%d):\n%s" % (
                        src.name, proc.returncode, out))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, path.name)
        left = max(timeout - (time.perf_counter() - t0), 0.1)
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib, *objects],
                              capture_output=True, text=True, timeout=left)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed to link (%d):\n%s%s" % (
                proc.returncode, proc.stdout, proc.stderr))
        os.replace(lib, path)
    return path, time.perf_counter() - t0, "".join(logs)


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
