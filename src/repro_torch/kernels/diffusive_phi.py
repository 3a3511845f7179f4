"""ctypes wrappers of the hand-written CUDA kernels for the diffusive φ
update (``csrc/diffusive_phi.cu``; it replaces the Pallas TPU kernels
``repro/kernels/diffusive_phi.py::diffusive_phi`` and
``::diffusive_phi_sparse``).

The source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3`` (no ``--use_fast_math``: IEEE division
keeps ``1/F`` and the final ``/ (deg + 1)`` bit-identical to PyTorch's) into
a shared library with a plain C interface under ``build/`` at the root of
the checkout, named by the hash of the source so an edited kernel is
rebuilt.  Nothing is built or loaded when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream, raises on a
non-zero ``cudaError_t``, and adds one to its entry of ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "diffusive_phi.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset (read by chip_smoke.py to
# show that the simulator's main path went through the kernels)
LAUNCHES = {"diffusive_phi": 0, "diffusive_phi_sparse": 0}

_lib = None
_lib_lock = threading.Lock()


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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"diffusive_phi_{digest}.so"


def build() -> Path:
    """Compile the kernels into ``build/`` unless this source is built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.diffusive_phi_launch.argtypes = [p, p, p, p, i, i, i, p]
            lib.diffusive_phi_launch.restype = i
            lib.diffusive_phi_sparse_launch.argtypes = [p, p, p, p, p, i, i,
                                                        i, i, p]
            lib.diffusive_phi_sparse_launch.restype = i
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
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


def _device_of(inv_phi: torch.Tensor) -> torch.device:
    if inv_phi.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{inv_phi.device}")
    return inv_phi.device


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def diffusive_phi(inv_phi: torch.Tensor, F: torch.Tensor,
                  d_tx_masked: torch.Tensor) -> torch.Tensor:
    """Eq. 10, dense, on the card.  inv_phi [R, N], F [R, N], d_tx_masked
    [R, N, N] float32 (NEG = -1e30 off-link) -> inv_phi' [R, N]."""
    device = _device_of(inv_phi)
    if inv_phi.dim() != 2:
        raise ValueError("inv_phi must be [R, N]")
    R, N = inv_phi.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    f32 = torch.float32
    _check("inv_phi", inv_phi, f32, (R, N), device)
    _check("F", F, f32, (R, N), device)
    _check("d_tx_masked", d_tx_masked, f32, (R, N, N), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = _load().diffusive_phi_launch(
        inv_phi.data_ptr(), F.data_ptr(), d_tx_masked.data_ptr(),
        out.data_ptr(), R, N, device.index, _stream(device))
    _raise_on(err, "diffusive_phi")
    LAUNCHES["diffusive_phi"] += 1
    return out


def diffusive_phi_sparse(inv_phi: torch.Tensor, F: torch.Tensor,
                         d_tx_masked: torch.Tensor,
                         nbr: torch.Tensor) -> torch.Tensor:
    """Eq. 10 over neighbour lists, on the card.  inv_phi [R, N], F [R, N],
    d_tx_masked [R, N, K] float32 (NEG on invalid/off-link slots), nbr
    [R, N, K] int32 in [0, N) -> inv_phi' [R, N].  A row with an index
    outside [0, N) comes out NaN."""
    device = _device_of(inv_phi)
    if d_tx_masked.dim() != 3:
        raise ValueError("d_tx_masked must be [R, N, K]")
    R, N, K = d_tx_masked.shape
    if R * N >= 2 ** 31:
        raise ValueError(f"R·N = {R * N} rows do not fit one launch")
    f32 = torch.float32
    _check("inv_phi", inv_phi, f32, (R, N), device)
    _check("F", F, f32, (R, N), device)
    _check("d_tx_masked", d_tx_masked, f32, (R, N, K), device)
    _check("nbr", nbr, torch.int32, (R, N, K), device)
    out = torch.empty((R, N), dtype=f32, device=device)
    if R * N == 0:
        return out
    err = _load().diffusive_phi_sparse_launch(
        inv_phi.data_ptr(), F.data_ptr(), d_tx_masked.data_ptr(),
        nbr.data_ptr(), out.data_ptr(), R, N, K, device.index,
        _stream(device))
    _raise_on(err, "diffusive_phi_sparse")
    LAUNCHES["diffusive_phi_sparse"] += 1
    return out
