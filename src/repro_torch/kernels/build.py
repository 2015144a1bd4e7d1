"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each library is one ``csrc/*.cu`` source with a plain C interface, compiled
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library at first use; the sources share the building blocks of
``csrc/tile_staging.cuh``. The build directory is ``kernels/_build/``
beside this module (git-ignored), one subdirectory per hash of the source,
the shared headers and the flags, so an edited source or header is rebuilt
and an unchanged one is not. All
missing libraries are compiled at once, one ``nvcc`` per source. A failed
build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
LIBRARIES = ("escg_update_fused", "escg_update", "density", "philox",
             "reference_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the lattice types the update, scan and histogram kernels are compiled for
CELL_DTYPES = (torch.int8, torch.int16, torch.int32)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _source(name: str) -> Path:
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r}; have {LIBRARIES}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build_log(name: str) -> str:
    """What nvcc printed for the built library (``-Xptxas -v``: registers,
    shared memory and spills per kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), all
    ``nvcc`` processes started together; returns name -> library path."""
    names = tuple(LIBRARIES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        paths[n].parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=paths[n].parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_source(n))]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.escg_error_string.argtypes = [ctypes.c_int]
        lib.escg_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.escg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# PyTorch's current stream on a card as a raw pointer, the C call that its
# generated kernels use: far cheaper per launch than building the
# torch.cuda.Stream of torch.cuda.current_stream. A build of PyTorch
# without CUDA lacks it, and has no CUDA tensors to launch on.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_args(t: torch.Tensor) -> Tuple[int, ctypes.c_void_p]:
    """(device index, current stream) for a launch on ``t``'s card; a
    tensor that is not on a card raises."""
    if not t.is_cuda:
        raise ValueError(f"the kernels run on CUDA tensors; got a tensor "
                         f"on {t.device}")
    index = t.get_device()
    return index, ctypes.c_void_p(_raw_stream(index))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A contiguous tensor's data pointer for a C argument."""
    if not t.is_contiguous():
        raise ValueError("the kernels take contiguous tensors")
    return ctypes.c_void_p(t.data_ptr())


def check_tables(grid: torch.Tensor, dom: torch.Tensor,
                 dirs: torch.Tensor) -> None:
    """The update kernels' tables: ``dom`` a square float32 dominance
    matrix and ``dirs`` the (8, 2) int32 direction table, both on the
    grid's device."""
    if dom.dtype != torch.float32 or dom.dim() != 2 \
            or dom.shape[0] != dom.shape[1]:
        raise ValueError("dom must be a square float32 matrix")
    if dirs.dtype != torch.int32 or tuple(dirs.shape) != (8, 2):
        raise ValueError("dirs must be the (8, 2) int32 direction table")
    for name, t in (("dom", dom), ("dirs", dirs)):
        if t.device != grid.device:
            raise ValueError(f"{name} is on {t.device}, grid on "
                             f"{grid.device}")
