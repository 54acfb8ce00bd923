"""The port's flash-attention op and RMSNorm kernel wrapper against the JAX package's.

On the CPU the port's wrappers compute their plain versions; the JAX kernels
run in Pallas interpret mode, as tests/test_kernels.py runs them.  Inputs
are made with NumPy from a seed and handed to both.  The tolerances are
those of tests/test_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as jrms  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402

torch.set_num_threads(2)

CASES = [
    # b, sq, sk, h, kv, d, causal, window, dtype, tol  (tests/test_kernels.py CASES)
    (1, 128, 128, 4, 4, 64, True, 0, "float32", 2e-5),
    (2, 256, 256, 4, 2, 64, True, 0, "float32", 2e-5),
    (1, 128, 384, 4, 1, 64, False, 0, "float32", 2e-5),  # cross-attn, MQA
    (1, 256, 256, 8, 2, 32, True, 64, "float32", 2e-5),  # sliding window
    (1, 200, 200, 2, 2, 64, True, 0, "float32", 2e-5),   # non-block-multiple
    (1, 128, 128, 4, 4, 128, True, 0, "float32", 2e-5),  # d=128
    (1, 128, 128, 4, 4, 64, True, 0, "bfloat16", 3e-2),
    (2, 128, 128, 2, 1, 64, False, 32, "bfloat16", 3e-2),
]

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(b, sq, sk, h, kv, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32))


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:9]) for c in CASES])
def test_flash_op_matches_jax(case):
    b, sq, sk, h, kv, d, causal, window, dt, tol = case
    arrs = _qkv(b, sq, sk, h, kv, d)
    want = jops.flash_attention(*(jnp.asarray(a, _JDT[dt]) for a in arrs), causal, window)
    before = tfa.launches
    got = tops.flash_attention(*(torch.from_numpy(a).to(_TDT[dt]) for a in arrs),
                               causal=causal, window=window)
    assert got.dtype == _TDT[dt] and got.shape == (b, sq, h, d)
    assert tfa.launches == before  # the CPU path is the plain version, not a launch
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_gradients_match_jax():
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=0)
    gj = jax.grad(lambda a, b_, c: jops.flash_attention(a, b_, c).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tops.flash_attention(tq, tk, tv).sum().backward()
    for a, b_ in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4, atol=1e-5)


def test_flash_wrapper_never_falls_back_off_the_cpu():
    # a tensor that is not on the CPU goes to the kernel's checks, never to the
    # plain version: here a meta tensor, which the kernel cannot take
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q, q)


RMS_CASES = [
    ((4, 128), "float32"),
    ((2, 200, 64), "float32"),   # non-multiple rows
    ((1, 64, 256), "bfloat16"),
]


@pytest.mark.parametrize("case", RMS_CASES, ids=[str(c) for c in RMS_CASES])
def test_rmsnorm_ref_matches_jax(case):
    shape, dt = case
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal((shape[-1],), dtype=np.float32) * 0.1
    want = jref.rmsnorm_ref(jnp.asarray(x, _JDT[dt]), jnp.asarray(g))
    got = tref.rmsnorm_ref(torch.from_numpy(x).to(_TDT[dt]), torch.from_numpy(g))
    assert got.dtype == _TDT[dt]
    tol = 2e-2 if dt == "bfloat16" else 2e-6
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", RMS_CASES, ids=[str(c) for c in RMS_CASES])
def test_rmsnorm_wrapper_matches_jax_kernel(case):
    # the JAX Pallas kernel in interpret mode against the port's wrapper on CPU
    # tensors (its plain version), at tests/test_kernels.py's tolerances
    shape, dt = case
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal((shape[-1],), dtype=np.float32) * 0.1
    want = jrms.rmsnorm(jnp.asarray(x, _JDT[dt]), jnp.asarray(g))
    before = trms.launches
    got = trms.rmsnorm(torch.from_numpy(x).to(_TDT[dt]), torch.from_numpy(g))
    assert trms.launches == before  # the CPU path is the plain version, not a launch
    assert got.dtype == _TDT[dt] and tuple(got.shape) == shape
    tol = 2e-2 if dt == "bfloat16" else 2e-6
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dev,g_dev", [("meta", "meta"), ("meta", "cpu"), ("cpu", "meta")])
def test_rmsnorm_wrapper_never_falls_back_off_the_cpu(x_dev, g_dev):
    # anything not wholly on the CPU goes to the kernel's checks, never to the
    # plain version: meta tensors, which the kernel cannot take, raise
    x = torch.empty((4, 64), device=x_dev)
    g = torch.empty((64,), device=g_dev)
    before = trms.launches
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm(x, g)
    assert trms.launches == before


# -- the dispatch between the two flash kernels, and the wrapper's checks

@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_variant_rule(dt, d):
    # fp32 runs the 3xTF32 wgmma/TMA kernel at every head dim; bf16 at head_dim
    # >= 16 the bf16 wgmma/TMA kernel, and at 8 the SIMT one
    want = "tf32" if dt == "float32" else "sm90" if d >= 16 else "simt"
    assert tfa.variant(_TDT[dt], d) == want
    assert want in tfa.SOURCES


@pytest.mark.parametrize("d", [4, 24, 48, 96, 256])
def test_flash_head_dim_outside_head_dims_raises(d):
    assert d not in tfa.HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        tfa.variant(torch.bfloat16, d)
    q = torch.empty((1, 8, 2, d), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q)


def test_flash_variant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tfa.variant(torch.float16, 64)


@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_cpu_tensors_take_plain(dt, d):
    # CPU tensors take the plain version, whichever kernel a CUDA input would
    # run, and move neither launch counter
    q, k, v = (torch.from_numpy(a).to(_TDT[dt]) for a in _qkv(1, 40, 40, 4, 2, d))
    before, by_variant = tfa.launches, dict(tfa.launches_by_variant)
    got = tfa.flash_attention_fwd(q, k, v, True, 0)
    assert tfa.launches == before and tfa.launches_by_variant == by_variant
    assert torch.equal(got, tfa.plain(q, k, v, True, 0))


def _meta_qkv(d, dtype=torch.bfloat16, offset=0):
    # meta tensors (no data, no device) whose data_ptr is offset elements past
    # a 16-byte boundary
    n = 8 * 2 * d
    base = torch.empty(offset + n, dtype=dtype, device="meta")
    q = base[offset:].view(1, 8, 2, d)
    return q, q, q


@pytest.mark.parametrize("case", [
    # (dtype, head_dim, offset in elements, kernel, error)
    ("bfloat16", 64, 1, None, "16-byte boundary"),     # sm90: misaligned for TMA
    ("bfloat16", 128, 4, None, "16-byte boundary"),    # 8 bytes off
    ("bfloat16", 16, 8, "sm90", "lie on one CUDA"),    # 16 bytes off: aligned, then the device
    ("bfloat16", 64, 1, "simt", "lie on one CUDA"),    # simt has no alignment rule
    ("float32", 64, 1, None, "16-byte boundary"),      # fp32 goes to tf32: TMA alignment
    ("float32", 128, 2, "tf32", "16-byte boundary"),   # 8 bytes off
    ("float32", 64, 4, None, "lie on one CUDA"),       # 16 bytes off: aligned, then the device
    ("float32", 8, 0, "tf32", "lie on one CUDA"),      # tf32 takes head_dim 8
    ("float32", 64, 1, "simt", "lie on one CUDA"),     # simt still takes fp32, any alignment
    ("float32", 64, 0, "sm90", "no kernel 'sm90'"),    # sm90 is bf16 only
    ("bfloat16", 64, 0, "tf32", "no kernel 'tf32'"),   # tf32 is fp32 only
    ("bfloat16", 8, 0, "sm90", "no kernel 'sm90'"),    # bf16 head_dim 8 is simt's alone
    ("bfloat16", 48, 0, None, "head_dim 48"),          # not a head dim any kernel takes
    ("float32", 48, 0, "tf32", "head_dim 48"),
    ("bfloat16", 64, 0, "mma", "no kernel 'mma'"),
], ids=str)
def test_flash_wrapper_checks_raise_before_launch(case):
    dt, d, offset, kernel, match = case
    q, k, v = _meta_qkv(d, _TDT[dt], offset)
    before, by_variant = tfa.launches, dict(tfa.launches_by_variant)
    with pytest.raises(ValueError, match=match):
        tfa.launch(q, k, v, kernel=kernel)
    assert tfa.launches == before and tfa.launches_by_variant == by_variant


# ---------------------------------------------------------------------------
# thread safety: the ranks of a LocalMesh reach the kernels from 16 threads
# ---------------------------------------------------------------------------


def test_load_builds_once_and_launch_counts_stay_exact_across_threads(monkeypatch):
    import sys
    import threading
    import time
    import types

    from repro_torch.kernels import _build

    builds = []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.05)  # a second thread arrives while the first builds

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(CDLL=lambda path: object()))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(tfa, "launches", 0)
    monkeypatch.setattr(tfa, "launches_by_variant", dict.fromkeys(tfa.SOURCES, 0))
    monkeypatch.setattr(trms, "launches", 0)
    names, per_thread, n_threads = _build.sources(), 2000, 16
    libs = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def rank(i):
        start.wait()
        libs[i] = [_build.load(n) for n in names]
        for _ in range(per_thread):
            tfa.count_launch("tf32")
            trms.count_launch()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        threads = [threading.Thread(target=rank, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(builds) == sorted((n,) for n in names)  # each library built once
    assert all(lib == libs[0] for lib in libs)  # and every thread got the same one
    assert tfa.launches == tfa.launches_by_variant["tf32"] == n_threads * per_thread
    assert trms.launches == n_threads * per_thread
