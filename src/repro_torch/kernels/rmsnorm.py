"""Fused RMSNorm forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm``.  On a CUDA tensor the
wrapper launches the hand-written kernel of ``csrc/rmsnorm.cu`` (see the note
at its top for its design and its bound); on CPU tensors it computes the
plain version, ``ref.rmsnorm_ref``.  It never falls back from the one to the
other: a CUDA input the kernel cannot take raises.  Forward only, as in the
JAX package, whose ``pallas_call`` has no VJP; the models' norms do not call
it, as the JAX models do not.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, ref

SOURCE = "rmsnorm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The one-pass kernel's compiled instances: 16-byte vectors a thread (VPT),
# one block of at most MAX_THREADS a row; `instance` picks one from d.
ROW_INSTANCES = tuple(range(1, 9))
MAX_THREADS = 1024
_TARGET_THREADS = 256

# Kernel launches since the caller last set this to 0 (plain calls not counted).
# ``count_launch`` adds under a lock, since the ranks of a LocalMesh launch
# from threads of their own.
launches = 0
_count_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The function the kernel computes, in plain torch."""
    return ref.rmsnorm_ref(x, gamma, eps)


def instance(d: int, dtype: torch.dtype, aligned: bool = True) -> tuple[int, int]:
    """(VPT, threads) of the kernel that normalises rows of width d.

    VPT in ``ROW_INSTANCES``: the one-pass kernel, one block of ``threads`` a
    row, VPT 16-byte vectors a thread held in registers.  VPT 0: the general
    path (a warp a row, 8 rows a block of 256), for d that is not a multiple of
    the 16-byte vector, pointers off a 16-byte boundary (``aligned`` False), or
    rows longer than ``ROW_INSTANCES[-1] * MAX_THREADS`` vectors.
    """
    vec = 16 // (4 if dtype == torch.float32 else 2)
    nvec = d // vec
    if not aligned or d % vec or nvec > ROW_INSTANCES[-1] * MAX_THREADS:
        return 0, 256
    vpt = min(max(1, -(-nvec // _TARGET_THREADS)), ROW_INSTANCES[-1])
    per_thread = -(-nvec // vpt)
    return vpt, -(-per_thread // 32) * 32


@functools.cache
def _entry():
    fn = _build.load(SOURCE).repro_rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, gamma):
    if not (x.is_cuda and gamma.is_cuda) or x.device != gamma.device:
        raise ValueError("rmsnorm: x and gamma must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES or gamma.dtype != torch.float32:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and float32 gamma; got "
                        f"{x.dtype}, {gamma.dtype}")
    if x.dim() == 0 or gamma.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm wants x (..., d) and gamma (d,); got {tuple(x.shape)}, "
                         f"{tuple(gamma.shape)}")
    d = x.shape[-1]
    if d == 0 or x.numel() // d >= 2**31 or d >= 2**31:
        raise ValueError(f"rmsnorm: unsupported shape {tuple(x.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), gamma (d,) -> x·rsqrt(mean(x², -1) + eps)·(1 + gamma), in x's dtype.

    The JAX version's TPU tiling knob ``block_rows`` and its ``interpret``
    switch have no counterpart: the layout follows from d (``instance``), and
    CPU tensors take the plain version.
    """
    if x.device.type == gamma.device.type == "cpu":
        return plain(x, gamma, eps)
    _check(x, gamma)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    if rows == 0:
        return y
    aligned = not any(t.data_ptr() % 16 for t in (x, gamma, y))
    vpt, threads = instance(d, x.dtype, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), gamma.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype],
                       rows, d, float(eps), vpt, threads, stream)
    if err:
        raise RuntimeError(f"rmsnorm: kernel launch failed with cudaError {err}")
    count_launch()
    return y
