"""The arithmetic and layouts of the port's fp32 flash kernel (3xTF32) and RMSNorm dispatch.

The CUDA kernels run only on the GPU; what they rest on is checked here on
the CPU: a 3xTF32 emulation of the attention held against the JAX package's
reference at the shapes of tests/test_kernels.py (and a single TF32 product
shown to miss the same tolerance), the tf32 rounding, the split of K and V
with V^T's key permutation held against P V through the wgmma fragment
order, and the RMSNorm width dispatch against the instances compiled in
``csrc/rmsnorm.cu``.  Inputs are made with NumPy from a seed.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-5  # the fp32 flash tolerance of tests/test_kernels.py
# b, sq, sk, h, kv, d, causal, window: the fp32 shapes of tests/test_kernels.py
# CASES, then head_dim 16 and 8 with ragged lengths and Sq != Sk
CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 4, 1, 64, False, 0),
    (1, 256, 256, 8, 2, 32, True, 64),
    (1, 200, 200, 2, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 128, True, 0),
    (2, 70, 70, 4, 2, 16, True, 0),
    (1, 33, 33, 2, 1, 8, True, 0),
    (1, 100, 60, 4, 2, 32, True, 0),
]


def _qkv(b, sq, sk, h, kv, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32))


def _tf32_mm(a, b):
    """a @ b of tf32 values, rounded to fp32 once: each product of two 11-bit
    significands is exact in float64, and so is their sum over these shapes'
    K but for float64's own rounding, far below fp32's.  The result does not
    depend on the order or the kernel in which the CPU's GEMM adds the
    products, as an fp32 GEMM's does."""
    return (a.double() @ b.double()).float()


def _product(a, b, terms):
    """a @ b with both operands split into tf32 hi and lo parts; ``terms`` 3 sums
    a_hi b_hi + a_hi b_lo + a_lo b_hi, 1 keeps a_hi b_hi alone.  Each product is
    formed exactly and rounded to fp32 (``_tf32_mm``); the three are added in
    fp32, as the tensor cores' fp32 accumulators keep them."""
    a_hi, b_hi = tfa.tf32_round(a), tfa.tf32_round(b)
    out = _tf32_mm(a_hi, b_hi)
    if terms == 3:
        out = (out + _tf32_mm(a_hi, tfa.tf32_round(b - b_hi))
               + _tf32_mm(tfa.tf32_round(a - a_hi), b_hi))
    return out


def _emulated_attention(q, k, v, causal, window, terms):
    """The tf32 kernel's arithmetic in fp32: S and P V through ``_product``, the
    softmax unnormalised (P <= 1) until the end, masked scores -1e30.  P's
    exponentials and their row sums are formed in float64 and rounded to fp32
    once (``_exp``), so that they do not depend on the CPU's exp: in a process
    that had run XLA, torch's fp32 exp now and then (1 run in 4) gave P 1.05e-4
    from its values on the next call, which put 299 of 32768 outputs past the
    tolerance."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    s = _product(qh, kh.transpose(-1, -2), terms) / np.float32(np.sqrt(d))
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    s = torch.where(keep, s, torch.tensor(-1e30))
    p = _exp(s - s.amax(-1, keepdim=True))
    o = _product(p, vh, terms) / p.double().sum(-1, keepdim=True).float()
    return o.permute(0, 2, 1, 3)


def _exp(x):
    """fp32 ``exp(x)``, formed in float64 and rounded once."""
    return torch.exp(x.double()).float()


def _err_over_tol(got, want):
    err = np.abs(got - want)
    return float((err / (TOL * (1 + np.abs(want)))).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_tf32_products_meet_the_fp32_tolerance(case):
    *shape, causal, window = case
    arrs = _qkv(*shape)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), causal=causal,
                                               window=window))
    got = _emulated_attention(*(torch.from_numpy(a) for a in arrs), causal, window, terms=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_tf32_product_misses_the_fp32_tolerance(case):
    # why the kernel forms three products: one keeps ~3 decimal digits
    *shape, causal, window = case
    arrs = _qkv(*shape)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), causal=causal,
                                               window=window))
    got = _emulated_attention(*(torch.from_numpy(a) for a in arrs), causal, window, terms=1)
    assert _err_over_tol(got.numpy(), want) > 1.0


def _rna_tf32(x):
    """Round to 11 significant bits, ties away from zero, in float64 (NumPy)."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) / 2.0**11
    return np.ldexp(r, e).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -20, 20, 4096).astype(np.float32)
    # ties: 11 significant bits and a twelfth that is set, both signs
    ties = (np.arange(1, 513, dtype=np.float32) * 2 + 1) / np.float32(2**12) + 1
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    got = tfa.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_tf32(x))
    assert not (got.view(np.int32) & 0x1FFF).any()  # 13 low mantissa bits clear


@pytest.mark.parametrize("sk", [64, 60, 33, 8])
def test_split_kv_parts_and_layout(sk):
    _, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, sk, 1, 3, 16, seed=sk))
    k_hi, k_lo, vt_hi, vt_lo = tfa.split_kv(k, v)
    skp = -(-sk // 8) * 8
    assert k_hi.shape == k_lo.shape == k.shape
    assert vt_hi.shape == vt_lo.shape == (2, 3, 16, skp)
    for part in (k_hi, k_lo, vt_hi, vt_lo):
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()  # exact tf32 values
    err = (k_hi.double() + k_lo.double() - k.double()).abs()
    assert float((err / k.double().abs().clamp_min(1e-30)).max()) < 2.0**-21
    vt = (vt_hi.double() + vt_lo.double())
    for j in range(skp):
        key = j // 8 * 8 + tfa.key_perm(j % 8)
        if key >= sk:
            assert not vt[..., j].any()  # zeros for keys past Sk
        else:
            want = v[:, key].permute(1, 2, 0).double()  # (kv, d, b) -> compare per batch
            np.testing.assert_allclose(vt[:, :, :, j].permute(1, 2, 0).numpy(), want.numpy(),
                                       rtol=2.0**-21, atol=0)


# The wgmma register layouts the tf32 kernel relies on, from the PTX ISA's
# figures, for thread `lane` of one warp (its 16 rows of the 64-row tile):
# accumulator element i of an 8-column group sits at (row, column)
_ACC = {0: (0, 0), 1: (0, 1), 2: (8, 0), 3: (8, 1)}  # + (lane // 4, 2 * (lane % 4))
# register-A fragment element i of a .tf32 k8 slab sits at (row, column)
_FRAG_A = {0: (0, 0), 1: (8, 0), 2: (0, 4), 3: (8, 4)}  # + (lane // 4, lane % 4)
# the kernel's choice: fragment element t takes accumulator element _TAKES[t]
_TAKES = {0: 0, 1: 2, 2: 1, 3: 3}


def _fragment_order(p):
    """The logical A operand of P V as the kernel builds it from the S accumulator
    of a (16, n) warp tile p: each k8 slab's fragment takes the accumulator's
    registers as they are."""
    rows, n = p.shape
    a = torch.full_like(p, float("nan"))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for kk in range(n // 8):
            for i in range(4):
                ar, ac = _ACC[_TAKES[i]]
                fr, fc = _FRAG_A[i]
                a[g + fr, 8 * kk + t + fc] = p[g + ar, 8 * kk + 2 * t + ac]
    assert not a.isnan().any()  # every logical position is filled once
    return a


@pytest.mark.parametrize("sk", [64, 40, 17])
def test_pv_through_the_fragment_order_matches_pv(sk):
    rng = np.random.default_rng(sk)
    _, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, sk, 1, 1, 32, seed=sk))
    _, _, vt_hi, vt_lo = tfa.split_kv(k, v)
    skp = vt_hi.shape[-1]
    p = torch.zeros(16, skp, dtype=torch.float64)
    p[:, :sk] = torch.from_numpy(rng.random((16, sk)))
    vt = (vt_hi + vt_lo).double()[0, 0]  # (d, skp), keys permuted
    got = _fragment_order(p) @ vt.T  # the kernel's k8 slabs, column j against V^T row j
    want = p[:, :sk] @ v[0, :, 0].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # without the permutation the same fragments would pair keys wrongly
    plain_vt = torch.zeros_like(vt)
    plain_vt[:, :sk] = v[0, :, 0].double().T
    assert not torch.allclose(_fragment_order(p) @ plain_vt.T, want, rtol=1e-3, atol=1e-3)


# -- RMSNorm: the width dispatch against the compiled instances

def _compiled_row_instances():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    return {int(n) for n in re.findall(r"case (\d+): return launch_row<T, \1>", src)}


def test_rmsnorm_row_instances_are_compiled():
    assert set(trms.ROW_INSTANCES) == _compiled_row_instances()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_rmsnorm_dispatch_covers_every_d_model(arch, dt):
    dtype = getattr(torch, dt)
    d = get_config(arch).d_model
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    vpt, threads = trms.instance(d, dtype)
    assert vpt in _compiled_row_instances()  # the one-pass kernel, not the general path
    assert threads % 32 == 0 and 32 <= threads <= trms.MAX_THREADS
    assert vpt * threads >= d // vec > (vpt - 1) * threads  # every vector once, none idle


@pytest.mark.parametrize("d,dt,aligned", [
    (77, "float32", True), (1000, "bfloat16", False), (4 * 8 * 1024 + 4, "float32", True),
    (3, "bfloat16", True),
])
def test_rmsnorm_dispatch_general_path(d, dt, aligned):
    # d off the vector width, a misaligned pointer, or a row too long for the
    # registers takes the general kernel (VPT 0)
    assert trms.instance(d, getattr(torch, dt), aligned) == (0, 256)


def _stored_q_lo(q):
    """Q_lo as the tf32 kernel keeps it: fp16 of tf32(q - q_hi) times 2^(12 - e),
    2^e <= max |q| of the row < 2^(e + 1), read back times 2^(e - 12)."""
    q_hi = tfa.tf32_round(q)
    lo = tfa.tf32_round(q - q_hi)
    _, exp = torch.frexp(q.abs().amax(-1, keepdim=True))
    e = (exp - 1).clamp_min(-100).float()
    return (lo * torch.exp2(12 - e)).half().float() * torch.exp2(e - 12), lo


@pytest.mark.parametrize("row_scale", [1e-3, 1.0, 50.0, 3e4, 1e6])
def test_q_lo_fp16_storage_is_exact(row_scale):
    # the scaled fp16 holds every lo that lands in its normal range exactly;
    # a smaller lo (below 2^-26 of the row's largest value) is off by less than
    # 2^-36 of that largest value, far below fp32's rounding of the products
    rng = np.random.default_rng(int(row_scale) + 1)
    q = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)) * row_scale
    stored, lo = _stored_q_lo(q)
    rowmax = q.abs().amax(-1, keepdim=True)
    normal = lo.abs() >= rowmax * 2.0**-26
    assert normal.float().mean() > 0.99
    assert torch.equal(stored[normal], lo[normal])
    assert float(((stored - lo).abs() / rowmax).max()) < 2.0**-36
    assert float((stored.abs() * torch.exp2(-(torch.frexp(rowmax)[1] - 1) + 12.0)).max()) <= 4
    assert not (stored.view(torch.int32) & 0x1FFF).any()  # still exact tf32 values
