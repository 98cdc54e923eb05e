"""The traffic generator: every mix is a data file it reads.

``traffic/<name>.json`` holds a mix's parameters.  Its ``kind`` names the
module that runs it, ``kinds/<kind>.py``; a mix of a kind this module
does not draw brings its generator in that module.  A serving mix
(``"kind": "serve"``) is a closed loop of ``clients``, each asking the
questions of one document after another: a session is a document of
``document`` tokens asked ``asks_per_document`` times, each ask the
document with a question of ``question`` tokens appended (none: the
document alone), answered in ``output`` tokens.  A training mix
(``"kind": "train"``) is ``batch`` rows of ``seq`` tokens a step.

Every seed gets the same sizes in another order, so the work of a window
does not depend on the seed: the sizes are the ``pool`` quantiles of each
distribution, and each block of ``pool`` sessions (or asks) takes them in
a permutation drawn from the seed.  Token ids are uniform over the
vocabulary, drawn from the seed and the session's index, so no two
documents share a page.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["load", "quantiles", "Ask", "Sessions", "train_batch",
           "max_request_tokens"]


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    kind = spec.get("kind")
    if not isinstance(kind, str) or not kind.isidentifier():
        raise ValueError(f"{path}: kind must name a module kinds/<kind>.py")
    return spec


def quantiles(dist: dict, n: int) -> List[int]:
    """The ``n`` mid-point quantiles of a length distribution:
    ``loguniform`` or ``uniform`` over [min, max], whole tokens."""
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "loguniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        elif dist["dist"] == "uniform":
            x = lo + u * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {dist['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def max_request_tokens(spec: dict) -> int:
    """The longest prompt plus answer the mix can send."""
    q = spec.get("question")
    return (int(spec["document"]["max"]) + (int(q["max"]) if q else 0)
            + int(spec["output"]["max"]))


class Ask(NamedTuple):
    session: int
    ask: int              # 0 .. asks_per_document - 1
    prompt: List[int]
    max_new_tokens: int


class Sessions:
    """The seeded stream of sessions of a serving mix: ``next_session()``
    hands out the next session's asks, in order."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, int(seed)
        self.pool = int(spec["pool"])
        self.doc_sizes = quantiles(spec["document"], self.pool)
        self.out_sizes = quantiles(spec["output"], self.pool)
        q = spec.get("question")
        self.q_sizes = quantiles(q, self.pool) if q else None
        self.asks = int(spec.get("asks_per_document", 1))
        self._perms: Dict[tuple, np.ndarray] = {}
        self.issued = 0

    def _pick(self, what: str, sizes: List[int], i: int) -> int:
        block, k = divmod(i, self.pool)
        key = (what, block)
        if key not in self._perms:
            rng = np.random.default_rng([self.seed, len(what), block,
                                         sum(map(ord, what))])
            self._perms[key] = rng.permutation(self.pool)
        return sizes[int(self._perms[key][k])]

    def session(self, s: int) -> List[Ask]:
        """Session ``s``'s asks."""
        rng = np.random.default_rng([self.seed, s])
        doc = rng.integers(0, self.vocab, self._pick("doc", self.doc_sizes,
                                                     s)).tolist()
        out = []
        for a in range(self.asks):
            i = s * self.asks + a
            prompt = doc
            if self.q_sizes is not None:
                n = self._pick("question", self.q_sizes, i)
                prompt = doc + rng.integers(0, self.vocab, n).tolist()
            out.append(Ask(s, a, prompt,
                           self._pick("output", self.out_sizes, i)))
        return out

    def next_session(self) -> List[Ask]:
        s = self.issued
        self.issued += 1
        return self.session(s)


def train_batch(spec: dict, vocab: int, seed: int, step: int,
                device: torch.device,
                rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch, drawn on ``device`` from the seed: tokens
    ``[batch, seq]`` uniform over the vocabulary and labels the next
    token (-1 at each row's end)."""
    from cellbench.weights import group_seed
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, f"batch.{step}"))
    toks = torch.randint(0, vocab, (int(spec["batch"]), int(spec["seq"])),
                         generator=gen, device=device, dtype=torch.int64)
    toks = toks.to(torch.int32)
    labels = torch.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    if rows is not None:
        toks, labels = toks[rows], labels[rows]
    return {"tokens": toks, "labels": labels}
