"""Deterministic synthetic data pipeline (copy of ``repro.data.pipeline``).

Batches come from NumPy's generator seeded with (seed, step), exactly as in
the JAX package, so both packages see bit-identical prompts.  Tensors are
made from them by the caller, on the device it chose.
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


def make_batch(cfg: ArchConfig, seq_len: int, global_batch: int, step: int = 0,
               seed: int = 0):
    """One batch with all model-specific extras (positions)."""
    data = SyntheticLM(DataConfig(cfg.vocab, seq_len, global_batch, seed)).batch(step)
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(
            np.arange(seq_len, dtype=np.int32), (3, global_batch, seq_len)
        ).copy()
        data["positions"] = pos
    if cfg.enc_layers:
        raise NotImplementedError(
            "encoder frames for the audio family come with the audio slice "
            "(ROADMAP Queue A, VLM and audio families)"
        )
    return data
