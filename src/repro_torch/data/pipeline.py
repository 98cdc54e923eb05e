"""Data pipeline: deterministic synthetic streams + memmap token files.

Copied from ``repro/data/pipeline.py`` (pure numpy); only this note
differs.  Batches are bit-identical to the JAX package's for the same
:class:`DataConfig`, so a trainer in either package sees the same data
at the same step.

Host-sharded: each process reads only its slice of the global batch
(``process_index`` / ``process_count``).  Two sources:

* :class:`SyntheticTokens` — deterministic counter-hash stream (splitmix64),
  reproducible across restarts from (seed, step) alone: the fault-tolerance
  path needs *exact* resumability without data-state checkpoints.
* :class:`MemmapTokens` — flat binary uint16/uint32 token file, sequence-
  chunked, epoch-shuffled with a seeded permutation; the production path.

Both yield {tokens, labels} numpy batches; labels are tokens shifted left
with -1 (masked) at sequence ends.  Frontend stubs (src_embeds /
patch_embeds) are generated deterministically from the same counter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "MemmapTokens", "make_source"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    path: Optional[str] = None          # memmap file -> MemmapTokens
    process_index: int = 0
    process_count: int = 1
    # frontend stubs
    src_embeds_dim: int = 0             # encdec: emit src_embeds [B,S/ratio,D]
    src_ratio: int = 4
    patch_embeds: int = 0               # vlm: emit patch_embeds [B,P,D]
    d_model: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.process_count == 0, \
            (self.global_batch, self.process_count)
        return self.global_batch // self.process_count


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic counter hash (vectorized splitmix64)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    x ^= x >> np.uint64(31)
    return x


def _labels_from(tokens: np.ndarray) -> np.ndarray:
    labels = np.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    return labels


class SyntheticTokens:
    """Deterministic synthetic tokens: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.local_batch, cfg.seq_len
        row0 = step * cfg.global_batch + cfg.process_index * b
        idx = (np.uint64(cfg.seed) << np.uint64(40)) \
            + (np.arange(row0, row0 + b, dtype=np.uint64)[:, None]
               << np.uint64(20)) \
            + np.arange(s, dtype=np.uint64)[None, :]
        tokens = (_splitmix64(idx) % np.uint64(cfg.vocab)).astype(np.int32)
        out = {"tokens": tokens, "labels": _labels_from(tokens)}
        self._add_stubs(out, step)
        return out

    def _add_stubs(self, out: Dict[str, np.ndarray], step: int) -> None:
        cfg = self.cfg
        b = cfg.local_batch
        if cfg.src_embeds_dim:
            s_src = max(cfg.seq_len // cfg.src_ratio, 1)
            n = b * s_src * cfg.src_embeds_dim
            raw = _splitmix64(np.arange(n, dtype=np.uint64)
                              + np.uint64(step * 7919))
            emb = (raw.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
            out["src_embeds"] = emb.reshape(b, s_src, cfg.src_embeds_dim)
        if cfg.patch_embeds:
            n = b * cfg.patch_embeds * cfg.d_model
            raw = _splitmix64(np.arange(n, dtype=np.uint64)
                              + np.uint64(step * 104729))
            emb = (raw.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
            out["patch_embeds"] = emb.reshape(b, cfg.patch_embeds, cfg.d_model)
            # patch positions carry no next-token target
            out["labels"][:, :cfg.patch_embeds] = -1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapTokens:
    """Flat binary token file, host-sharded, seeded epoch shuffle."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path, "MemmapTokens needs cfg.path"
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_seqs = len(self.data) // cfg.seq_len
        if self.n_seqs < cfg.global_batch:
            raise ValueError(
                f"file holds {self.n_seqs} sequences of {cfg.seq_len}; need "
                f">= global_batch {cfg.global_batch}")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.local_batch
        steps_per_epoch = self.n_seqs // cfg.global_batch
        epoch, within = divmod(step, steps_per_epoch)
        rng = np.random.default_rng(cfg.seed + epoch)
        perm = rng.permutation(self.n_seqs)
        row0 = within * cfg.global_batch + cfg.process_index * b
        rows = perm[row0:row0 + b]
        tokens = np.stack([
            self.data[r * cfg.seq_len:(r + 1) * cfg.seq_len] for r in rows
        ]).astype(np.int32) % cfg.vocab
        return {"tokens": tokens, "labels": _labels_from(tokens)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_source(cfg: DataConfig):
    return MemmapTokens(cfg) if cfg.path else SyntheticTokens(cfg)
