"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  On a
CUDA tensor the wrapper launches the hand-written kernel of
``csrc/flash_attention.cu`` (see the note at its top for its design and its
bound); on CPU tensors it computes the plain version,
``ref.flash_attention_ref``.  It never falls back from the one to the other:
a CUDA input the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

SOURCE = "flash_attention"
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the caller last set this to 0 (plain calls not counted).
launches = 0


def plain(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The function the kernel computes, in plain torch."""
    return ref.flash_attention_ref(q, k, v, causal, window)


@functools.cache
def _entry():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention_fwd: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 q, k, v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd wants q (B,Sq,H,D) and k, v (B,Sk,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, sk, kv, dk = k.shape
    if bk != b or dk != d or kv == 0 or h % kv:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim, or H is not a multiple of KV")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in {HEAD_DIMS}")
    if min(b, sq, sk) == 0 or b * h > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported sizes B={b} Sq={sq} Sk={sk} H={h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention_fwd: window must be >= 0, got {window}")


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√D + mask) v for q (B,Sq,H,D) and k, v (B,Sk,KV,D)."""
    global launches
    if q.device.type == k.device.type == v.device.type == "cpu":
        return plain(q, k, v, causal, window)
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       _DTYPE_CODES[q.dtype], b, sq, sk, h, kv, d, int(causal), int(window),
                       stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with cudaError {err}")
    launches += 1
    return out
