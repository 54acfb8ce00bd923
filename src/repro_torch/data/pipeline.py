"""Deterministic synthetic data pipeline (copy of ``repro.data.pipeline``).

Batches come from NumPy's generator seeded with (seed, step), exactly as in
the JAX package, so both packages see bit-identical prompts.  Tensors are
made from them by the caller, on the device it chose.  The audio family's
encoder frames are the JAX package's bfloat16 values, held in float32
arrays (``bf16_round``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1  # token distribution (natural-ish LM statistics)


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


class SyntheticLM:
    """Stateless batch generator: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(min(cfg.vocab, 4096), cfg.zipf_alpha)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng([self.cfg.seed, step])
        b, s = self.cfg.global_batch, self.cfg.seq_len
        toks = rng.choice(len(self._probs), size=(b, s + 1), p=self._probs)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to the nearest bfloat16 (ties to even), as float32.

    ``astype(ml_dtypes.bfloat16)`` rounds so; NumPy has no bfloat16, so the
    low 16 bits of each finite value are rounded away here.
    """
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def make_batch(cfg: ArchConfig, seq_len: int, global_batch: int, step: int = 0,
               seed: int = 0):
    """One batch with all model-specific extras (positions / frames).

    The frames are float32 arrays of bfloat16 values, where the JAX package
    returns bfloat16 ones; the model casts them to its dtype either way.
    """
    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch, seed)).batch(step)
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(
            np.arange(seq_len, dtype=np.int32), (3, global_batch, seq_len)
        ).copy()
        data["positions"] = pos
    if cfg.enc_layers:
        rng = np.random.default_rng([seed, step, 7])
        data["encoder_frames"] = bf16_round(rng.standard_normal(
            (global_batch, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    return data
