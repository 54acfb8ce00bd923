"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``) and a
seed give every batch a cell runs, the same ones for the same seed.

A mix holds:

- ``kind``: ``train`` (batches of tokens and next-token labels) or ``prefill``
  (requests of prompts whose first token is served);
- ``batch`` and ``seq``: rows a batch and tokens a row;
- ``segments``: the start of every row, text runs (``{"text": n}``) and images
  (``{"image": [t, h, w]}``, the grid after the patch merge); text fills the
  rest of the row;
- ``token_pool`` (optional): the number of token ids the prompts are drawn
  from, uniformly; the run's seed picks that many ids of the vocabulary.
  Without it every id of the vocabulary is as likely as any other;
- for training ``first_steps``, the steps that set-up runs and the reference
  follows; training steps run back to back;
- for prefill ``rate_per_s``, the calls due a second, whether or not the last
  has completed; ``warmup_calls``; and ``check_rows``, the served rows of the
  window that the reference recomputes.
"""

from __future__ import annotations

import hashlib

import torch

KINDS = ("train", "prefill")


def validate(name: str, mix: dict) -> dict:
    """``mix`` if its parameters are whole and consistent; raises otherwise."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind must be one of {KINDS}")
    counts = ("batch", "seq") + (("first_steps",) if mix["kind"] == "train"
                                 else ("warmup_calls", "check_rows"))
    for key in counts + ("token_pool",) * ("token_pool" in mix):
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"traffic {name}: {key} must be a positive integer")
    if mix["kind"] == "prefill" and not mix.get("rate_per_s", 0) > 0:
        raise ValueError(f"traffic {name}: prefill calls need rate_per_s > 0")
    if segment_tokens(mix["segments"]) > mix["seq"]:
        raise ValueError(f"traffic {name}: its segments hold more than {mix['seq']} tokens")
    return mix


def segment_tokens(segments: list) -> int:
    n = 0
    for seg in segments:
        if "text" in seg:
            n += seg["text"]
        else:
            t, h, w = seg["image"]
            n += t * h * w
    return n


def row_seed(seed: int, index: int | str) -> int:
    """A 63-bit seed for batch (or draw) ``index`` of a run seeded ``seed``."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def positions(mix: dict, mrope: bool) -> torch.Tensor:
    """Positions of one row: (S,) for RoPE, or (3, S) (t, h, w) for M-RoPE, laid
    out as Qwen2-VL's rope index lays them out. Text counts on with t = h = w;
    an image's tokens take its first position plus their (t, h, w) index in
    the grid; the text after an image counts on from one past the largest
    position before it."""
    rows, nxt = [], 0
    for seg in mix["segments"] + [{"text": mix["seq"] - segment_tokens(mix["segments"])}]:
        if "text" in seg:
            text = nxt + torch.arange(seg["text"])
            rows.append(text.expand(3, -1))
            nxt += seg["text"]
        else:
            grid = torch.stack(torch.meshgrid(*(torch.arange(g) for g in seg["image"]),
                                              indexing="ij")).reshape(3, -1)
            rows.append(nxt + grid)
            nxt = int((nxt + grid).max()) + 1
    pos = torch.cat(rows, dim=1).to(torch.int32)
    return pos if mrope else pos[0]


def rows(batch: dict, index) -> dict:
    """The rows ``index`` (a slice or a list) of ``batch``."""
    return {k: (v[:, index] if k == "positions" and v.dim() == 3 else v[index])
            for k, v in batch.items()}


class Feed:
    """The batches of one run: ``batch(i)`` is the i-th, drawn on ``device`` from
    the run's seed and i alone, so the reference can draw it again."""

    def __init__(self, mix: dict, vocab: int, mrope: bool, seed: int, device):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.device = torch.device(device)
        pos = positions(mix, mrope).to(self.device)
        b = mix["batch"]
        self.positions = (pos[:, None].expand(3, b, -1) if mrope else pos.expand(b, -1)).contiguous()
        self.pool = None
        if "token_pool" in mix:
            if mix["token_pool"] > vocab:
                raise ValueError(f"a token pool of {mix['token_pool']} ids in a vocabulary "
                                 f"of {vocab}")
            gen = torch.Generator(self.device).manual_seed(row_seed(seed, "token_pool"))
            self.pool = torch.randperm(vocab, generator=gen, device=self.device)[:mix["token_pool"]]

    def batch(self, index: int) -> dict:
        b, s = self.mix["batch"], self.mix["seq"]
        gen = torch.Generator(self.device).manual_seed(row_seed(self.seed, index))
        train = self.mix["kind"] == "train"
        high = self.vocab if self.pool is None else len(self.pool)
        ids = torch.randint(0, high, (b, s + train), generator=gen, device=self.device)
        if self.pool is not None:
            ids = self.pool[ids]
        out = {"tokens": ids[:, :s].contiguous(), "positions": self.positions}
        if train:
            out["labels"] = ids[:, 1:].contiguous()
        return out

    @property
    def tokens_per_batch(self) -> int:
        return self.mix["batch"] * self.mix["seq"]
