"""Flash-attention forward: the CUDA kernels' wrapper and their plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  On CUDA
tensors the wrapper launches one of two hand-written kernels, chosen by
``variant``: ``csrc/flash_attention_sm90.cu`` (wgmma, TMA, warp-specialised;
bf16 with head_dim >= 16) or ``csrc/flash_attention.cu`` (fp32 arithmetic on
the CUDA cores; fp32, and bf16 at head_dim 8).  The note at the top of each
source gives its design and its bound.  On CPU tensors the wrapper computes
the plain version, ``ref.flash_attention_ref``.  It never falls back from
one to another: a CUDA input the chosen kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

SOURCES = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SM90_BLOCK_Q = 128  # q rows a CTA; the q tiles are the grid's y axis

# Kernel launches since the caller last reset them (plain calls not counted):
# in all, and by variant.
launches = 0
launches_by_variant = dict.fromkeys(SOURCES, 0)


def plain(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The function the kernels compute, in plain torch."""
    return ref.flash_attention_ref(q, k, v, causal, window)


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves (dtype, head_dim) on a CUDA device.

    bf16 with head_dim >= 16 goes to ``"sm90"``, the tensor-core kernel; fp32,
    and bf16 at head_dim 8, to ``"simt"``.  Anything else raises.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {head_dim} not in {HEAD_DIMS}")
    return "sm90" if dtype == torch.bfloat16 and head_dim >= 16 else "simt"


@functools.cache
def _entry(name: str):
    if name == "sm90":
        fn = _build.load(SOURCES[name]).repro_flash_attention_fwd_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        fn = _build.load(SOURCES[name]).repro_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, kernel=None) -> str:
    """The kernel that runs these inputs (``kernel``, else ``variant``'s choice).

    Raises, launching nothing, unless that kernel can take them.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd wants q (B,Sq,H,D) and k, v (B,Sk,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, sq, h, d = q.shape
    bk, sk, kv, dk = k.shape
    if bk != b or dk != d or kv == 0 or h % kv:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim, or H is not a multiple of KV")
    chosen = variant(q.dtype, d)
    name = chosen if kernel is None else kernel
    if name not in SOURCES or (name == "sm90" and chosen != "sm90"):
        raise ValueError(f"flash_attention_fwd: no kernel {name!r} for {q.dtype} at "
                         f"head_dim {d}")
    if min(b, sq, sk) == 0 or b * h > 65535 or -(-sq // _SM90_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported sizes B={b} Sq={sq} Sk={sk} H={h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention_fwd: window must be >= 0, got {window}")
    if name == "sm90" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: the sm90 kernel's TMA loads need q, k and v "
                         "to start on a 16-byte boundary")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention_fwd: q, k and v must lie on one CUDA device")
    return name


def launch(q, k, v, causal: bool = True, window: int = 0, kernel: str | None = None):
    """Run a kernel on CUDA tensors: ``kernel`` ("sm90" or "simt"), else ``variant``'s choice.

    Raises if that kernel cannot take the inputs.  Naming the kernel lets a
    caller run the SIMT kernel on bf16 inputs too, to compare the two.
    """
    global launches
    name = _check(q, k, v, window, kernel)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (b, sq, sk, h, kv, d, int(causal), int(window), stream)
        if name == "simt":
            args = (_DTYPE_CODES[q.dtype], *args)
        err = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
    if err:
        raise RuntimeError(f"flash_attention_fwd: the {name} kernel failed to launch with "
                           f"error {err}")
    launches += 1
    launches_by_variant[name] += 1
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√D + mask) v for q (B,Sq,H,D) and k, v (B,Sk,KV,D)."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return plain(q, k, v, causal, window)
    return launch(q, k, v, causal, window)
