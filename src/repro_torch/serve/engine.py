"""Serving engine: fused greedy generate over dense or paged KV caches.

Port of ``repro/serve/engine.py::Engine.generate``.  One call prefills the
right-padded prompts, then loops sample -> record -> eos-mask -> decode on
the device, and ends in exactly ONE device->host transfer
(:meth:`Engine._fetch`, audited by ``engine.host_syncs``).  The JAX
package's ``lax.while_loop`` exits early once every row is done, which
needs the done mask on the host; the port instead runs ``max_new_tokens``
steps and masks finished rows with ``done``/``n`` exactly as the JAX loop
body does, which returns the same tokens without a sync per step.

With ``page_size > 0`` the KV cache is a call-sized page pool: the host
plans a row-major page table (page 0 is the null page), exactly as the
JAX engine does, and decode attention reads only each row's live pages
through the paged kernel.

The continuous-batching ``BatchScheduler``, the prefix cache, int8 pages,
sampled decoding, speculative decoding and mesh sharding wait for later
slices (``ROADMAP.md``); the config fields that select them raise
:class:`NotImplementedError` here rather than being silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import sampling
from repro_torch.models.lm import LM
from repro_torch.serve.kv_pool import pages_for

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 1024
    batch_slots: int = 4            # scheduler only (accepted, unused here)
    temperature: float = 0.0        # 0 -> greedy (the only ported method)
    top_k: int = 0
    top_p: float = 1.0
    eos_token: int = -1             # -1 -> never stop early
    seed: int = 0
    admission_chunk: int = 8        # scheduler only (accepted, unused here)
    attn_impl: Optional[str] = None
    impls: Optional[Mapping[str, str]] = None
    # paged KV cache: tokens per page (0 -> dense call-sized caches)
    page_size: int = 0
    pool_pages: Optional[int] = None    # scheduler only (accepted, unused)
    kv_dtype: Optional[str] = None
    prefix_cache: bool = True       # scheduler only (accepted, unused here)


class Engine:
    def __init__(self, lm: LM, cfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None):
        """``device`` defaults to ``cuda`` (raising when there is none);
        ``lm`` must already live there."""
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"the LM lives on {lm.device}, the engine was "
                             f"asked for {self.device}")
        if cfg.temperature > 0.0:
            raise NotImplementedError(
                "temperature > 0 (sampled top_k/top_p decoding) is not "
                "ported yet (ROADMAP.md, queue 1 item 5)")
        if cfg.kv_dtype is not None:
            raise NotImplementedError(
                "kv_dtype (fp32/bf16/int8 page storage) is not ported yet "
                "(ROADMAP.md, queue 1 item 7: int8 pages with kernel #3)")
        if cfg.impls or cfg.attn_impl is not None:
            raise NotImplementedError(
                "impls/attn_impl kernel pins need the kernel registry, which "
                "is not ported yet (ROADMAP.md, queue 1 item 11); this "
                "slice dispatches by tensor device")
        self.lm = lm
        self.cfg = cfg
        self.host_syncs = 0             # device->host transfers (audited)
        self.paged = cfg.page_size > 0

    # -------------------------------------------------------------- helpers
    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """THE device->host sync point: every transfer is counted here."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def _pad_prompts(self, prompts: Sequence[Sequence[int]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Right-pad to the longest prompt; per-row true lengths ride along
        (pad keys are masked out via batch["lengths"])."""
        maxlen = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), maxlen), np.int32)
        lens = np.array([len(p) for p in prompts], np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        return toks, lens

    def _page_plan(self, prompts: Sequence[Sequence[int]],
                   max_new: int) -> Tuple[np.ndarray, int]:
        """Call-sized pool plan: exactly the pages this call can touch,
        laid out row-major after the null page 0, the pool rounded up to
        16 pages (the JAX engine's plan, so both touch the same pages)."""
        ps = self.cfg.page_size
        per_row = [pages_for(len(p) + max_new, ps) for p in prompts]
        table_width = max(per_row)
        num_pages = -(-(1 + sum(per_row)) // 16) * 16
        table = np.zeros((len(prompts), table_width), np.int32)
        nxt = 1
        for i, npages in enumerate(per_row):
            table[i, :npages] = np.arange(nxt, nxt + npages)
            nxt += npages
        return table, num_pages

    # ----------------------------------------------------------------- API
    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32) -> List[List[int]]:
        """Static-batch greedy generation: one host sync per call."""
        cfg, lm, dev = self.cfg, self.lm, self.device
        toks, lens = self._pad_prompts(prompts)
        if toks.shape[1] + max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"prompt ({toks.shape[1]}) + max_new ({max_new_tokens}) "
                f"exceeds max_seq ({cfg.max_seq})")
        b = len(prompts)
        # size the cache to THIS call's worst case, not cfg.max_seq
        need = toks.shape[1] + max_new_tokens
        seq_cap = min(cfg.max_seq, -(-need // 32) * 32)
        if self.paged:
            table, num_pages = self._page_plan(prompts, max_new_tokens)
            state = lm.init_decode_state(
                b, seq_cap, page_size=cfg.page_size, num_pages=num_pages,
                table_width=table.shape[1])
            state["caches"].page_table.copy_(torch.from_numpy(table))
        else:
            state = lm.init_decode_state(b, seq_cap)
        # the attention-cache family masks pad keys per row via lengths
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "lengths": torch.from_numpy(lens).to(dev)}
        logits, state = lm.prefill(batch, state)

        out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        n = torch.zeros((b,), dtype=torch.int32, device=dev)
        for t in range(max_new_tokens):
            nxt = sampling.sample(logits, method="greedy")
            emit = ~done
            out[:, t] = torch.where(emit, nxt, 0)
            n += emit.to(torch.int32)
            if cfg.eos_token >= 0:
                done |= emit & (nxt == cfg.eos_token)
            if t + 1 < max_new_tokens:      # the last step's logits go unused
                logits, state = lm.decode_step(nxt[:, None], state)
        host = self._fetch(torch.cat([out, n[:, None]], dim=1))  # the ONE sync
        return [host[i, :host[i, -1]].tolist() for i in range(b)]
