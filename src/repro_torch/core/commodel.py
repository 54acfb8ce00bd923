"""α-β running-time models of the paper's allreduce algorithms (§V-A2).

The port's copy of the part of ``repro.core.commodel`` that
``repro_torch.core.collectives.select_algorithm`` needs (stdlib only; the
port imports nothing of ``repro``): the paper's example accelerator's link
constants and the four algorithm models.  The communication volumes and the
workload models stay in ``repro``.
"""

from __future__ import annotations

import math

# -- hardware constants of the paper's example accelerator -------------------
LINK_BPS = 50e9  # bytes/s per 400 Gb/s link
PLANES = 4
INJECTION_BPS = 4 * LINK_BPS  # 4 planes x 400 Gb/s = 200 GB/s (1.6 Tb/s)
ALPHA = 1.0e-6  # per-message latency (s); SST config: ~20-40ns/hop + switch


def t_ring(p: int, size_bytes: float, beta: float = 1 / INJECTION_BPS, alpha: float = ALPHA) -> float:
    """Pipelined unidirectional ring: T ≈ 2pα + 2Sβ."""
    return 2 * p * alpha + 2 * size_bytes * beta


def t_bidir_ring(p: int, size_bytes: float, beta: float = 1 / INJECTION_BPS, alpha: float = ALPHA) -> float:
    """Bidirectional ring (two NICs): T ≈ 2pα + Sβ."""
    return 2 * p * alpha + size_bytes * beta


def t_dual_hamiltonian(p: int, size_bytes: float, beta: float = 1 / INJECTION_BPS, alpha: float = ALPHA) -> float:
    """Two bidirectional rings on edge-disjoint Hamiltonian cycles (4 NICs):
    T ≈ 2pα + (S/2)β."""
    return 2 * p * alpha + size_bytes * beta / 2


def t_torus2d(p: int, size_bytes: float, beta: float = 1 / INJECTION_BPS, alpha: float = ALPHA) -> float:
    """2D-torus allreduce: row reduce-scatter → column allreduce → row
    allgather, two transposed copies in parallel on half the data each:
    T ≈ 4√p α + Sβ(1+2√p)/(2√p).

    β here is normalized to the full 4-interface injection bandwidth; the
    torus algorithm drives only two interfaces per phase, so its large-message
    bandwidth is 2x below the dual-Hamiltonian rings (paper §V-A2c / Fig 13:
    "the torus algorithm, which is 2x less bandwidth-efficient, achieves
    higher throughput at smaller message sizes")."""
    q = math.sqrt(p)
    return 4 * q * alpha + size_bytes * beta * (1 + 2 * q) / (2 * q)


ALGORITHMS = {
    "ring": t_ring,
    "bidir": t_bidir_ring,
    "hamiltonian": t_dual_hamiltonian,
    "torus": t_torus2d,
}


def best_algorithm(p: int, size_bytes: float, **kw) -> tuple[str, float]:
    """Multi-algorithm selection (paper Fig 13 conclusion)."""
    times = {name: fn(p, size_bytes, **kw) for name, fn in ALGORITHMS.items()}
    name = min(times, key=times.get)
    return name, times[name]
