"""Flash-attention forward: the CUDA kernels' wrapper and their plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  On CUDA
tensors the wrapper launches one of three hand-written kernels, chosen by
``variant``: ``csrc/flash_attention_sm90_tf32.cu`` (fp32 on the tensor cores
as three TF32 products, wgmma, TMA; every head dim), ``csrc/flash_attention_sm90.cu``
(wgmma, TMA, warp-specialised; bf16 with head_dim >= 16) or
``csrc/flash_attention.cu`` (fp32 arithmetic on the CUDA cores; bf16 at
head_dim 8, and any input when named, for comparison).  The note at the top
of each source gives its design and its bound.  On CPU tensors the wrapper
computes the plain version, ``ref.flash_attention_ref``.  It never falls back
from one to another: a CUDA input the chosen kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, ref

SOURCES = {"tf32": "flash_attention_sm90_tf32", "sm90": "flash_attention_sm90",
           "simt": "flash_attention"}
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SM90_BLOCK_Q = 128  # q rows a CTA; the q tiles are the grid's y axis
_KEY_GROUP = 8  # the tf32 kernel's V^T pads Sk to, and permutes keys within, groups of 8

# Kernel launches since the caller last reset them (plain calls not counted):
# in all, and by variant.  ``count_launch`` adds under a lock, since the ranks
# of a LocalMesh launch from threads of their own.
launches = 0
launches_by_variant = dict.fromkeys(SOURCES, 0)
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of the kernel ``name`` ("tf32", "sm90" or "simt")."""
    global launches
    with _count_lock:
        launches += 1
        launches_by_variant[name] += 1


def plain(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The function the kernels compute, in plain torch."""
    return ref.flash_attention_ref(q, k, v, causal, window)


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves (dtype, head_dim) on a CUDA device.

    fp32 goes to ``"tf32"`` (3xTF32 on the tensor cores), bf16 with head_dim
    >= 16 to ``"sm90"`` and bf16 at head_dim 8 to ``"simt"``.  Anything else
    raises.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "tf32"
    return "sm90" if head_dim >= 16 else "simt"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def key_perm(j: int) -> int:
    """Position j of an 8-key group of the tf32 kernel's V^T holds key ``key_perm(j)``."""
    return 2 * j if j < 4 else 2 * (j - 4) + 1


def split_kv(k: torch.Tensor, v: torch.Tensor):
    """Plain version of the tf32 kernel's ``split_kv``: fp32 k, v (B, Sk, KV, D) ->
    k_hi, k_lo (B, Sk, KV, D) and vt_hi, vt_lo (B, KV, D, Skp), Skp = Sk rounded
    up to 8, keys permuted within each group of 8 by ``key_perm``, zeros past Sk.
    Each x is x_hi + x_lo to ~2^-22, with x_hi = tf32(x) and x_lo = tf32(x - x_hi).
    """
    b, sk, kv, d = k.shape
    skp = -(-sk // _KEY_GROUP) * _KEY_GROUP
    k_hi = tf32_round(k)
    vt = torch.zeros((b, kv, d, skp), dtype=v.dtype, device=v.device)
    vt[..., :sk] = v.permute(0, 2, 3, 1)
    perm = torch.tensor([key_perm(j) for j in range(_KEY_GROUP)], device=v.device)
    vt = vt.view(b, kv, d, skp // _KEY_GROUP, _KEY_GROUP)[..., perm].reshape(b, kv, d, skp)
    vt_hi = tf32_round(vt)
    return k_hi, tf32_round(k - k_hi), vt_hi, tf32_round(vt - vt_hi)


_ARGTYPES = {
    # q, k, v, o, then ints (dtype), B, Sq, Sk, H, KV, D, causal, window, then the stream
    "simt": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "sm90": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    # q, k_hi, k_lo, vt_hi, vt_lo, o, then B, Sq, Sk, H, KV, D, Skp, causal, window, stream
    "tf32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    # k, v, k_hi, k_lo, vt_hi, vt_lo, then B, Sk, KV, D, Skp, stream
    "tf32_split": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_SYMBOLS = {"simt": "repro_flash_attention_fwd", "sm90": "repro_flash_attention_fwd_sm90",
            "tf32": "repro_flash_attention_fwd_tf32", "tf32_split": "repro_flash_tf32_split_kv"}


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load(SOURCES[name.removesuffix("_split")]), _SYMBOLS[name])
    fn.argtypes = _ARGTYPES[name]
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
    if name not in SOURCES or (name == "sm90" and chosen != "sm90") or (
            name == "tf32" and chosen != "tf32"):
        raise ValueError(f"flash_attention_fwd: no kernel {name!r} for {q.dtype} at "
                         f"head_dim {d}")
    if min(b, sq, sk) == 0 or b * h > 65535 or -(-sq // _SM90_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported sizes B={b} Sq={sq} Sk={sk} H={h}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention_fwd: window must be >= 0, got {window}")
    if name in ("sm90", "tf32") and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention_fwd: the {name} kernel's TMA loads need q, k and v "
                         "to start on a 16-byte boundary")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention_fwd: q, k and v must lie on one CUDA device")
    return name


def launch(q, k, v, causal: bool = True, window: int = 0, kernel: str | None = None):
    """Run a kernel on CUDA tensors: ``kernel`` ("tf32", "sm90" or "simt"), else
    ``variant``'s choice.

    Raises if that kernel cannot take the inputs.  Naming the kernel lets a
    caller run the SIMT kernel on any input too, to compare.  The tf32 kernel
    runs as two launches, ``split_kv`` then the attention, counted as one.
    """
    name = _check(q, k, v, window, kernel)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if name == "tf32":
            skp = -(-sk // _KEY_GROUP) * _KEY_GROUP
            k_hi, k_lo = torch.empty_like(k), torch.empty_like(k)
            vt_hi, vt_lo = (torch.empty((b, kv, d, skp), dtype=v.dtype, device=v.device)
                            for _ in range(2))
            parts = [t.data_ptr() for t in (k_hi, k_lo, vt_hi, vt_lo)]
            err = _entry("tf32_split")(k.data_ptr(), v.data_ptr(), *parts, b, sk, kv, d, skp,
                                       stream)
            if not err:
                err = _entry(name)(q.data_ptr(), *parts, out.data_ptr(), b, sq, sk, h, kv, d,
                                   skp, int(causal), int(window), stream)
        else:
            args = (b, sq, sk, h, kv, d, int(causal), int(window), stream)
            if name == "simt":
                args = (_DTYPE_CODES[q.dtype], *args)
            err = _entry(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
    if err:
        raise RuntimeError(f"flash_attention_fwd: the {name} kernel failed to launch with "
                           f"error {err}")
    count_launch(name)
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√D + mask) v for q (B,Sq,H,D) and k, v (B,Sk,KV,D)."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return plain(q, k, v, causal, window)
    return launch(q, k, v, causal, window)
