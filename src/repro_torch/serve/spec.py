"""Speculative decoding: draft/target pairing, accept policies, round math.

Port of ``repro/serve/spec.py``.  A **spec round**
(``Engine.spec_segment``; the math is here) is:

1. sample the pending token ``y`` from the carried logits,
2. draft ``K = num_draft_tokens`` candidates ``d_1..d_K`` with the draft
   model (K+1 decode steps, so the draft cache also covers ``d_K``'s
   position and rewinds uniformly),
3. verify the whole suffix ``[y, d_1..d_K]`` with the target in ONE
   multi-token prefill over the paged cache
   (``lm.prefill(..., prefix_len=row_lengths, all_logits=True)``): K+1
   next-token distributions ``o_0..o_K`` for one forward pass,
4. accept the longest prefix ``d_1..d_a`` the policy admits and rewind
   both models' per-row cache lengths to ``len + a + 1`` (rejected draft
   positions fall out of the attended window; the next round overwrites
   their pages),
5. carry logits that make the NEXT round's ``y`` the correct extra token
   (bonus, residual or rollback sample).

Accept policies (``SpecConfig.accept_policy``):

* ``greedy`` (temperature 0): ``d_i`` is accepted iff it equals
  ``argmax(o_{i-1})``; the carried logits are ``o_a`` verbatim, so every
  emitted token is the argmax of a target logit row at the context
  target-only decode would have used — greedy speculative tokens equal
  target-only tokens.  The argmax is :func:`repro_torch.kernels.sampling.
  block_argmax` (kernel #4 on the card).
* ``rejection`` (temperature > 0): ``d_i ~ q_i`` is accepted with
  probability ``min(1, p_i(d_i) / q_i(d_i))``; on the first rejection the
  carried distribution is the residual ``norm(max(p_a - q_{a+1}, 0))``,
  after K acceptances the bonus ``p_K``.  The carried logits are
  ``T * log(dist)`` (``-inf`` where ``dist`` is 0), so the engine's
  ordinary sample of ``carry / T`` IS the residual or bonus draw.
* ``auto``: ``greedy`` when ``temperature <= 0``, else ``rejection``.

Rows with ``spec_mask=False`` force ``a = 0`` and carry the plain target
distribution ``p_0`` (not the residual), so a non-spec row of a mixed
batch emits exactly one token a round.  The rejection draws come from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import sampling

__all__ = ["SpecConfig", "accept_speculative", "ACCEPT_POLICIES"]

ACCEPT_POLICIES = ("auto", "greedy", "rejection")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Draft/target pairing for speculative decoding.

    ``draft_config`` is the draft model's
    :class:`repro_torch.models.lm.LMConfig`; ``num_draft_tokens`` is K, the
    draft lookahead per round."""
    draft_config: Any
    num_draft_tokens: int = 4
    accept_policy: str = "auto"        # auto | greedy | rejection

    def resolve_policy(self, temperature: float) -> str:
        if self.accept_policy != "auto":
            return self.accept_policy
        return "greedy" if temperature <= 0.0 else "rejection"

    def signature(self) -> Tuple:
        """Snapshot-compat identity: restoring under a different pairing
        could not reproduce the token stream."""
        return (getattr(self.draft_config, "name", "?"),
                int(self.num_draft_tokens), self.accept_policy)

    def validate(self, target_cfg, serve_cfg=None) -> None:
        """Eager construction-time checks (``Engine.__init__`` and
        ``launch/cli.py`` both call this, so a bad pairing fails before
        any weights are built)."""
        from repro_torch.serve.engine import MASKED_FAMILIES
        k = int(self.num_draft_tokens)
        if k < 1:
            raise ValueError(f"num_draft_tokens must be >= 1, got {k}")
        if self.accept_policy not in ACCEPT_POLICIES:
            raise ValueError(
                f"unknown accept_policy {self.accept_policy!r}; choose "
                f"from {ACCEPT_POLICIES}")
        dc = self.draft_config
        if dc.vocab != target_cfg.vocab:
            raise ValueError(
                f"draft/target vocab mismatch: draft {dc.name!r} has "
                f"vocab={dc.vocab}, target {target_cfg.name!r} has "
                f"vocab={target_cfg.vocab} — verified tokens index one "
                f"shared vocabulary")
        for role, cfg in (("draft", dc), ("target", target_cfg)):
            if cfg.family not in MASKED_FAMILIES:
                raise ValueError(
                    f"speculative decoding needs an attention-cache "
                    f"decoder family ({MASKED_FAMILIES}); {role} config "
                    f"{cfg.name!r} is {cfg.family!r}"
                    + (" — encoder-decoder configs are unsupported"
                       if cfg.family == "encdec" else ""))
        if serve_cfg is not None:
            if serve_cfg.page_size <= 0:
                raise ValueError(
                    "speculative decoding needs a paged engine "
                    "(ServeConfig.page_size > 0): verify runs through the "
                    "paged suffix-prefill path and rollback rewinds "
                    "per-row page lengths")
            policy = self.resolve_policy(serve_cfg.temperature)
            if policy == "greedy" and serve_cfg.temperature > 0.0:
                raise ValueError(
                    "accept_policy='greedy' needs temperature 0 (exact "
                    "prefix match against the target argmax)")
            if policy == "rejection" and serve_cfg.temperature <= 0.0:
                raise ValueError(
                    "accept_policy='rejection' needs temperature > 0 "
                    "(use 'greedy' or 'auto' for deterministic decode)")
            if policy == "rejection" and (
                    getattr(serve_cfg, "top_k", 0)
                    or getattr(serve_cfg, "top_p", 1.0) < 1.0):
                raise ValueError(
                    "speculative rejection sampling supports "
                    "temperature-only sampling: the carried residual "
                    "distribution is already corrected, so a top-k/top-p "
                    "refilter of it would skew the accepted stream")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` along dim 1: [B, N, V], [B] -> [B, V]."""
    return torch.gather(
        x, 1, idx.long()[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def accept_speculative(draft_tokens: torch.Tensor,
                       draft_logits: torch.Tensor,
                       target_logits: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       policy: str, temperature: float = 0.0,
                       spec_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Longest accepted prefix and the carried logits of one spec round.

    Args:
      draft_tokens: [B, K] int32, ``d_1..d_K`` sampled from the draft.
      draft_logits: [B, K, V], the draft logits ``q_1..q_K`` each ``d_i``
        was sampled from (before the temperature).
      target_logits: [B, K+1, V], the verify logits ``o_0..o_K``; ``o_i``
        conditions on ``y, d_1..d_i``.
      generator: the rejection draws' ``torch.Generator`` (unused by
        greedy).
      policy: ``"greedy"`` or ``"rejection"`` (resolved, not ``"auto"``).
      temperature: the sampling temperature (rejection only).
      spec_mask: [B] bool; False rows force ``a = 0`` and carry the plain
        target distribution.

    Returns ``(accepted [B] int32 in [0..K], carry_logits [B, V])`` in the
    target logits' dtype."""
    b, k = draft_tokens.shape
    if spec_mask is None:
        spec_mask = torch.ones((b,), dtype=torch.bool,
                               device=draft_tokens.device)
    if policy == "greedy":
        v = target_logits.shape[-1]
        tgt = sampling.block_argmax(
            target_logits.reshape(b * (k + 1), v)).reshape(b, k + 1)
        flags = (draft_tokens == tgt[:, :k]) & spec_mask[:, None]
        acc = torch.cumprod(flags.to(torch.int32), dim=1).sum(dim=1)
        acc = acc.to(torch.int32)
        return acc, _take(target_logits, acc)
    if policy != "rejection":
        raise ValueError(f"unresolved accept policy {policy!r}")
    if generator is None:
        raise ValueError("the rejection policy needs a generator")
    t = float(temperature)
    q = torch.softmax(sampling.filtered_logits(draft_logits, temperature=t),
                      dim=-1)                                   # [B,K,V]
    p = torch.softmax(sampling.filtered_logits(target_logits,
                                               temperature=t),
                      dim=-1)                                   # [B,K+1,V]
    u = torch.rand((b, k), generator=generator, device=q.device)
    idx = draft_tokens.long()[..., None]
    q_tok = torch.gather(q, 2, idx)[..., 0]                     # [B,K]
    p_tok = torch.gather(p[:, :k], 2, idx)[..., 0]
    # accept d_i with prob min(1, p/q): u*q < p avoids the division (q > 0
    # by construction: the draft sampled d_i from q)
    ok = (u * q_tok < p_tok) & spec_mask[:, None]
    acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    acc = acc.to(torch.int32)
    p_a = _take(p, acc)
    # the residual needs q at the REJECTED position; q padded with zeros at
    # K makes full acceptance (a = K) the bonus draw from p_K
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    q_a = _take(q_pad, acc)
    # non-spec rows carry the PLAIN target distribution p_0
    q_a = torch.where(spec_mask[:, None], q_a, 0.0)
    dist = torch.clamp(p_a - q_a, min=0.0)
    norm = dist.sum(dim=-1, keepdim=True)
    # a degenerate all-zero residual (p == q to rounding): fall back to the
    # target distribution itself, identical in the limit
    dist = torch.where(norm > 0.0, dist, p_a)
    return acc, (t * torch.log(dist)).to(target_logits.dtype)
