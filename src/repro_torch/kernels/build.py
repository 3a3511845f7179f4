"""Build, load and guard the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3`` (no ``--use_fast_math``: IEEE division
and ``expf`` keep the kernels within the plain versions' rounding), linked
with ``-lcuda`` (libcuda's tensor-map encoder), into a shared
library with a plain C interface under ``build/`` at the root of the
checkout, named by the hash of the source and the flags, so an edited
kernel is rebuilt.  ``-Xptxas -v`` makes the compiler report each kernel's
registers, shared memory and spills; the report is kept beside the library
(``.log``).  Nothing is built or loaded when a module is imported.

Each wrapper checks device, dtype, shape and contiguity (``check``),
allocates its output with ``torch.empty``, launches on the current stream
(``stream``), raises on a non-zero ``cudaError_t`` (``raise_on``), and adds
one to its entry of ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
# after the source: libcuda (cuTensorMapEncodeTiled, for the TMA tensor
# maps of the flash kernel), from the toolkit's stub at link time
LINK_FLAGS = ("-lcuda",)

# the dtypes the kernels take, by the code their C launchers expect
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset (read by chip_smoke.py to
# show that a main path went through the kernels)
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


class CudaLibrary:
    """One ``csrc/*.cu`` source, its shared library and its C launchers.

    ``launchers`` maps each exported launcher to its ctypes argument types;
    every launcher returns the ``cudaError_t`` of its launch as an int.
    ``kernels`` names the kernels counted in ``LAUNCHES``.
    """

    def __init__(self, source: str, launchers: Dict[str, Sequence],
                 kernels: Iterable[str]):
        self.source = SOURCE_DIR / source
        self.launchers = launchers
        for name in kernels:
            LAUNCHES.setdefault(name, 0)
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS + LINK_FLAGS).encode()
                                ).hexdigest()[:12]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def _start(self) -> subprocess.Popen:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path().with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source),
               *LINK_FLAGS]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish(self, proc: subprocess.Popen) -> Path:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(proc.args)}\n{out}")
        final = self.path()
        final.with_suffix(".log").write_text(out)
        os.replace(proc.args[proc.args.index("-o") + 1], final)
        return final

    def build(self) -> Path:
        """Compile into ``build/`` unless this source is built."""
        return build_all([self])[0]

    def report(self) -> str:
        """What ptxas said about each kernel (registers, spills)."""
        log = self.build().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.launchers.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def build_all(libs: Sequence[CudaLibrary]) -> List[Path]:
    """Build every library not built yet, one ``nvcc`` per source, all
    started together."""
    procs = {i: lib._start() for i, lib in enumerate(libs)
             if not lib.path().exists()}
    return [lib._finish(procs[i]) if i in procs else lib.path()
            for i, lib in enumerate(libs)]


# ---------------------------------------------------------------------------
# guards shared by the wrappers
# ---------------------------------------------------------------------------


def device_of(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{t.device}")
    return t.device


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (grids are sized by it;
    no result depends on it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launched(err: int, name: str) -> None:
    """Raise on a failed launch; count a good one.  ``err`` is a
    ``cudaError_t``, or minus a ``CUresult`` where the launcher encodes a
    tensor map."""
    if err != 0:
        what = f"CUresult {-err}" if err < 0 else f"cudaError_t {err}"
        raise RuntimeError(f"{name} launch failed with {what}")
    LAUNCHES[name] += 1
