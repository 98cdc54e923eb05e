"""Serving engine: fused generate, speculative decoding and true
continuous batching.

Port of ``repro/serve/engine.py``.  Two layers:

* :class:`Engine` — the device work.  ``generate()`` prefills the
  right-padded prompts, then loops sample -> record -> eos-mask -> decode
  on the device, and ends in exactly ONE device->host transfer
  (:meth:`Engine._fetch`, audited by ``engine.host_syncs``).  The JAX
  package's ``lax.while_loop`` exits early once every row is done, which
  needs the done mask on the host; the port instead runs
  ``max_new_tokens`` steps and masks finished rows with ``done``/``n``
  exactly as the JAX loop body does, which returns the same tokens
  without a sync per step.  ``generate_reference`` is the per-token loop
  (one sample and one sync a token), the fused loop's oracle;
  ``generate(stream_cb=...)`` streams through the same loop.  The
  continuous-batching primitives (:meth:`Engine.prefill_slot`,
  :meth:`Engine.copy_pages`, :meth:`Engine.decode_segment`) update one
  shared decode state IN PLACE, where the JAX package donates its
  buffers.
* :class:`BatchScheduler` — a slot table over that shared state.  Decode
  runs in power-of-two segments of at most ``admission_chunk`` steps; ONE
  host sync per segment fetches the tokens; finished rows release their
  slots and queued requests prefill into them mid-flight at their exact
  prompt length.  On a paged engine it drives the :class:`KVPool`: exact
  page allocation at admission, a worst-case reservation (backpressure
  instead of overcommit), the shared-prefix radix cache with
  copy-on-write at the fork page, and a page table sliced to the live mix
  for every segment.  Bounded admission, priorities, deadlines, cancel and
  drain follow the JAX scheduler.

**Sampling.**  ``ServeConfig.temperature > 0`` samples ``top_k`` (when
``top_k > 0``) or ``top_p`` tokens: the filter and the Gumbel shift are
plain tensor ops and the argmax is kernel #4 (``kernels/sampling.py``).
``generate``, ``generate_reference``, streaming and each
``BatchScheduler.run`` own a ``torch.Generator`` on the engine's device
seeded from ``ServeConfig.seed``, as the JAX engine seeds
``jax.random.key(cfg.seed)``; every decode step draws one ``[B, V]``, in
step order, so the three static-batch loops return the same tokens.  In
the scheduler one stream is shared across slots, so a request's samples
depend on what it was co-scheduled with (greedy stays replayable).

**Speculative decoding** (``spec=SpecConfig``, ``draft_lm=``; paged
engines of an attention-cache family): each round samples ``y``, runs
K+1 draft decode steps, verifies ``[y, d_1..d_K]`` in one target prefill
with ``prefix_len`` and ``all_logits``, accepts through
:func:`repro_torch.serve.spec.accept_speculative` and rewinds both
caches' per-row lengths.  The JAX package runs the whole round loop as
one program with one sync; a round commits 1..K+1 tokens, so the port
cannot know the round count ahead.  Its fused ``generate`` runs
``ceil(max_new / (K + 1))`` rounds (the least any call needs) without a
sync, then reads one all-done flag per further round (each read counted
in ``host_syncs``; the last read carries the tokens), capped at
``max_new`` rounds as the reference's loop condition is.  The scheduler
runs one round per segment with one sync.  Draft pages live in the same
pool as the target's, in a second slot namespace (pool slot
``batch_slots + i`` mirrors target slot ``i``).

**Instrumentation.**  :meth:`Engine.instrument` attaches a
:class:`repro_torch.core.perfctr.PerfCtr` and probes the
``serve.prefill`` / ``serve.decode`` regions; the port's probe executes
what it measures, so it runs on a throwaway decode state.  From then on
every prefill and decode of the engine and its schedulers accumulates
into the regions through ``PerfCtr.region_timer``.

With ``page_size > 0`` the KV cache is a page pool (page 0 is the null
page) read by the paged decode kernels; ``kv_dtype`` stores the pages as
fp32, bf16 or int8 codes with per-token scales (the q8 kernel).  Only the
attention-cache families (:data:`MASKED_FAMILIES`) take pages and ragged
``lengths``; the hybrid family serves with dense KV, equal-length rows in
``generate`` and exact-length single-row admissions in the scheduler, as
in the JAX engine.

**Snapshots and chaos.**  With ``snapshot_dir`` set the scheduler writes
crash-safe serving snapshots (``repro_torch/checkpoint/store.py``, the
JAX package's file format, so either package restores the other's):
every ``snapshot_every`` segments and at exit.  A snapshot holds the
queue, every request's progress and the prefix index with its pages'
contents, fetched from the card in one transfer counted in
``host_syncs``; so with snapshots on, host syncs = segments + snapshots
that carry an index.  :meth:`Engine.restore` rebuilds a scheduler from
one: the saved pages are written into the fresh pool's tensors in place
before the first admission, and every pending request replays
``prompt + generated`` through prefill over them.  ``chaos`` ticks a
:class:`repro_torch.ft.chaos.ChaosSchedule` at every segment boundary.

Mesh sharding, kernel pins and ``extra_batch`` inputs wait for later
slices (``ROADMAP.md``); the arguments that select them raise
:class:`NotImplementedError` rather than being silently ignored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.device import resolve_device
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.kernels import sampling
from repro_torch.models.lm import LM
from repro_torch.serve import kv_pool
from repro_torch.serve.admission import AdmissionQueue, AdmissionRejected
from repro_torch.serve.spec import SpecConfig, accept_speculative

__all__ = ["ServeConfig", "Engine", "BatchScheduler", "Request",
           "KV_DTYPES", "TERMINAL_STATUSES", "MASKED_FAMILIES",
           "PREFILL_REGION", "DECODE_REGION"]

PREFILL_REGION = "serve.prefill"
DECODE_REGION = "serve.decode"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 1024
    batch_slots: int = 4
    temperature: float = 0.0        # 0 -> greedy
    # sampled decode (temperature > 0): top_k > 0 keeps the k best logits,
    # else top_p < 1.0 keeps the nucleus; the defaults (0, 1.0) are plain
    # categorical sampling of logits / temperature
    top_k: int = 0
    top_p: float = 1.0
    eos_token: int = -1             # -1 -> never stop early
    seed: int = 0
    admission_chunk: int = 8        # decode steps between admission points
    attn_impl: Optional[str] = None
    impls: Optional[Mapping[str, str]] = None
    # paged KV cache: tokens per page (0 -> dense call-sized caches)
    page_size: int = 0
    # pool capacity in pages (None -> dense worst case + segment headroom)
    pool_pages: Optional[int] = None
    # paged KV storage dtype: None keeps the model dtype; "fp32"/"bf16"
    # store pages in that dtype; "int8" stores codes with per-token f32
    # scales and decodes through the q8 kernel.  Paged engines only.
    kv_dtype: Optional[str] = None
    # shared-prefix radix cache (paged engines)
    prefix_cache: bool = True


#: ServeConfig.kv_dtype vocabulary -> page storage dtype
KV_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


#: families whose prefill masks right-padding per row (``lengths``); the
#: recurrent-state families (xlstm, hybrid) cannot un-run a pad token
#: through a running state: they serve equal-length waves in ``generate``
#: and exact-length single-row admissions in the scheduler, with dense KV
MASKED_FAMILIES = ("dense", "moe", "vlm")


#: Request.status values that end a request's life (no further tokens)
TERMINAL_STATUSES = ("done", "expired", "cancelled", "shed", "rejected")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0        # set by BatchScheduler.submit
    first_token_time: float = 0.0   # set when the first token reaches host
    finished: bool = False          # set by the scheduler (eos or budget)
    # ---- request-plane robustness (all optional; defaults = old behavior)
    priority: int = 1               # lower is more urgent (0 interactive,
                                    # 1 default, 2 batch); shed-lowest
                                    # evicts the worst class first
    deadline_ms: Optional[float] = None       # total wall budget from submit
    ttft_deadline_ms: Optional[float] = None  # first-token wall budget
    status: str = "new"             # new|queued|active|done|expired|
                                    # cancelled|shed|rejected
    cancel_requested: bool = False  # the cancellation token (see cancel())
    spec: bool = False              # speculative decoding opt-in (spec
                                    # engines only; ignored elsewhere)

    def cancel(self) -> None:
        """Request-side cancellation token: the scheduler retires the row
        (or dequeues the request) at the next segment boundary; no token
        generated after the flag is observed is ever returned."""
        self.cancel_requested = True

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def done(self) -> bool:
        return self.finished or len(self.generated) >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        """Time-to-first-token (segment-granular), None until measured."""
        if self.first_token_time and self.submit_time:
            return self.first_token_time - self.submit_time
        return None


State = Dict[str, Any]


class Engine:
    def __init__(self, lm: LM, cfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Any = None, spec: Optional[SpecConfig] = None,
                 draft_lm: Optional[LM] = None, perfctr: Any = None):
        """``device`` defaults to ``cuda`` (raising when there is none);
        ``lm`` must already live there.

        ``spec``: a :class:`repro_torch.serve.spec.SpecConfig` pairing a
        draft model with this target for speculative decoding (paged
        engines only).  The port's ``LM`` carries its weights, so the
        reference's ``draft_params`` is ``draft_lm``: an ``LM`` of
        ``spec.draft_config`` on the engine's device.  ``perfctr``: a
        :class:`repro_torch.core.perfctr.PerfCtr` whose ``serve.prefill``
        / ``serve.decode`` regions time this engine's work (see
        :meth:`instrument`)."""
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"the LM lives on {lm.device}, the engine was "
                             f"asked for {self.device}")
        if mesh is not None:
            raise NotImplementedError(
                "sharded serving over a mesh is not ported yet (ROADMAP.md, "
                "queue 1 item 14: mesh and fault tolerance)")
        if cfg.impls or cfg.attn_impl is not None:
            raise NotImplementedError(
                "impls/attn_impl kernel pins need the kernel registry, which "
                "is not ported yet (ROADMAP.md, queue 1 item 11); this "
                "slice dispatches by tensor device")
        self.lm = lm
        self.cfg = cfg
        self.perfctr = perfctr
        self.host_syncs = 0             # device->host transfers (audited)
        self.paged = cfg.page_size > 0
        if self.paged and lm.cfg.family not in MASKED_FAMILIES:
            raise ValueError(
                f"page_size={cfg.page_size} needs an attention-cache "
                f"family ({MASKED_FAMILIES}), not {lm.cfg.family!r}")
        self.kv_dtype: Optional[torch.dtype] = None
        if cfg.kv_dtype is not None:
            if not self.paged:
                raise ValueError(
                    f"kv_dtype={cfg.kv_dtype!r} needs a paged KV cache "
                    "(page_size > 0) — dense caches keep the model dtype")
            if cfg.kv_dtype not in KV_DTYPES:
                raise ValueError(
                    f"unknown kv_dtype {cfg.kv_dtype!r}; choose from "
                    f"{sorted(KV_DTYPES)}")
            self.kv_dtype = KV_DTYPES[cfg.kv_dtype]
        self.quantized = cfg.kv_dtype == "int8"
        # ---- speculative decoding: a draft model riding in the same pool
        self.spec = spec
        self.draft_lm: Optional[LM] = None
        self.spec_stats: Dict[str, Any] = {}
        if spec is not None:
            spec.validate(lm.cfg, cfg)
            if draft_lm is None:
                raise ValueError(
                    "Engine(spec=...) needs draft_lm (the draft model, an "
                    "LM of spec.draft_config on the engine's device)")
            if draft_lm.cfg != spec.draft_config:
                raise ValueError(
                    f"draft_lm is {draft_lm.cfg.name!r}, spec.draft_config "
                    f"is {spec.draft_config.name!r}: build the draft LM "
                    f"from the spec's config")
            if draft_lm.device != self.device:
                raise ValueError(f"the draft LM lives on {draft_lm.device}, "
                                 f"the engine on {self.device}")
            self.draft_lm = draft_lm
        self.spec_policy = (spec.resolve_policy(cfg.temperature)
                            if spec is not None else None)
        if self.paged:
            # table/pool headroom: power-of-two segments may overshoot a
            # request's budget by up to one segment of writes; a spec
            # round writes up to K+1 verify tokens past the committed
            # length before the rewind
            headroom = self.seg_cap
            if spec is not None:
                headroom = max(headroom, spec.num_draft_tokens + 1)
            self.table_width = kv_pool.table_width_for(
                cfg.max_seq, cfg.page_size, headroom)
            base_pages = kv_pool.recommended_pages(
                cfg.batch_slots, cfg.max_seq, cfg.page_size, headroom)
            # draft pages mirror the target's token for token: the second
            # namespace doubles the pool's worst case
            self.pool_pages = cfg.pool_pages or (
                2 * base_pages if spec is not None else base_pages)

    # -------------------------------------------------------------- helpers
    @property
    def seg_cap(self) -> int:
        """Largest power-of-two segment: quantized steps never exceed it."""
        return 1 << (max(self.cfg.admission_chunk, 1).bit_length() - 1)

    def quantize_steps(self, steps: int) -> int:
        """Round a requested step count UP to a power of two (capped at the
        admission chunk), as the JAX engine does to bound its compiled
        segment programs; the scheduler masks the overshoot against each
        request's ``max_new_tokens``, so no token is ever returned past
        it, and the port's segments match the JAX scheduler's."""
        steps = max(int(steps), 1)
        return min(1 << (steps - 1).bit_length(), self.seg_cap)

    @property
    def slot_headroom(self) -> int:
        """Tokens a slot's device length can grow past its budget in one
        segment: a quantized decode segment for plain engines, one K+1
        verify window for spec engines (rounds are their segments)."""
        if self.spec is not None:
            return self.spec.num_draft_tokens + 1
        return self.seg_cap

    @property
    def sampling_method(self) -> str:
        """The sampling method this engine decodes with."""
        cfg = self.cfg
        if cfg.temperature <= 0.0:
            return "greedy"
        return "top_k" if cfg.top_k else "top_p"

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """One sampling step: greedy takes no random numbers; sampled
        methods draw one ``[B, V]`` Gumbel shift from ``generator``, and
        kernel #4 picks every token."""
        cfg = self.cfg
        return sampling.sample(logits, generator, method=self.sampling_method,
                               temperature=max(cfg.temperature, 1e-6),
                               k=cfg.top_k, p=cfg.top_p)

    def _generator(self) -> torch.Generator:
        """A fresh stream on the engine's device seeded from
        ``ServeConfig.seed`` (the JAX engine's ``jax.random.key(seed)``)."""
        return torch.Generator(device=self.device).manual_seed(self.cfg.seed)

    def _region_timer(self, region: str):
        return (self.perfctr.region_timer(region) if self.perfctr is not None
                else contextlib.nullcontext())

    def _state_kwargs(self) -> Dict[str, Any]:
        """init_decode_state kwargs for this engine's cache flavor."""
        if not self.paged:
            return {}
        return dict(page_size=self.cfg.page_size,
                    num_pages=self.pool_pages,
                    table_width=self.table_width,
                    kv_dtype=self.kv_dtype)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without blocking the host: a pinned
        staging copy, then an asynchronous transfer on the current stream
        (a pageable copy would wait for every kernel queued before it)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def set_page_table(self, state: State, table: np.ndarray) -> State:
        """Swap the (host-managed) page table into a decode state."""
        caches = state["caches"]
        tbl = self._upload(np.asarray(table, np.int32))
        return dict(state, caches=caches._replace(page_table=tbl))

    def _fetch(self, t: Union[torch.Tensor, Mapping[str, torch.Tensor]]
               ) -> Union[np.ndarray, Dict[str, torch.Tensor]]:
        """THE device->host sync point: every transfer is counted here.

        A tensor comes back as a numpy array.  A mapping of tensors (a
        snapshot's page contents) comes back as host tensors of the same
        dtypes and shapes, moved in ONE transfer of their bytes, so bf16,
        which numpy lacks, survives bit for bit."""
        self.host_syncs += 1
        if isinstance(t, torch.Tensor):
            return t.cpu().numpy()
        flat = [v.contiguous().reshape(-1).view(torch.uint8)
                for v in t.values()]
        host = torch.cat(flat).cpu()
        out, off = {}, 0
        for (key, v), b in zip(t.items(), flat):
            chunk = host[off:off + b.numel()].clone()
            out[key] = chunk.view(v.dtype).reshape(v.shape)
            off += b.numel()
        return out

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
        per_row = [kv_pool.pages_for(len(p) + max_new, ps) for p in prompts]
        table_width = max(per_row)
        num_pages = -(-(1 + sum(per_row)) // 16) * 16
        table = np.zeros((len(prompts), table_width), np.int32)
        nxt = 1
        for i, npages in enumerate(per_row):
            table[i, :npages] = np.arange(nxt, nxt + npages)
            nxt += npages
        return table, num_pages

    def _spec_plan(self, prompts: Sequence[Sequence[int]],
                   max_new: int) -> Tuple[np.ndarray, int]:
        """Call-sized page plan for one spec namespace: every row gets
        pages for prompt + budget + the K+1 verify overshoot."""
        return self._page_plan(prompts,
                               max_new + self.spec.num_draft_tokens + 1)

    def _check_call(self, prompts: Sequence[Sequence[int]], max_new: int,
                    extra_batch: Optional[Mapping[str, Any]]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad the prompts and refuse what this engine cannot serve."""
        if extra_batch:
            raise NotImplementedError(
                "extra_batch (patch embeddings, source features) feeds the "
                "vlm and encdec families, which are not ported yet "
                "(ROADMAP.md, queue 1 item 12)")
        toks, lens = self._pad_prompts(prompts)
        if toks.shape[1] + max_new > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({toks.shape[1]}) + max_new ({max_new}) "
                f"exceeds max_seq ({self.cfg.max_seq})")
        return toks, lens

    def _prefill_call(self, toks: np.ndarray, lens: np.ndarray,
                      prompts: Sequence[Sequence[int]], max_new: int
                      ) -> Tuple[torch.Tensor, State]:
        """The static-batch prefill every plain loop starts from: a state
        sized to THIS call's worst case (a call-sized page plan on paged
        engines), pad keys masked per row for attention-cache families."""
        cfg, lm = self.cfg, self.lm
        b = len(prompts)
        need = toks.shape[1] + max_new
        seq_cap = min(cfg.max_seq, -(-need // 32) * 32)
        if self.paged:
            table, num_pages = self._page_plan(prompts, max_new)
            state = lm.init_decode_state(
                b, seq_cap, page_size=cfg.page_size, num_pages=num_pages,
                table_width=table.shape[1], kv_dtype=self.kv_dtype)
            state = self.set_page_table(state, table)
        else:
            state = lm.init_decode_state(b, seq_cap)
        # attention-cache families mask pad keys per row via lengths;
        # recurrent ones run pads as context (equal lengths are exact)
        batch = {"tokens": self._upload(toks)}
        if lm.cfg.family in MASKED_FAMILIES:
            batch["lengths"] = self._upload(lens)
        with self._region_timer(PREFILL_REGION):
            return lm.prefill(batch, state)

    # ----------------------------------------------------------------- API
    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 extra_batch: Optional[Mapping[str, Any]] = None,
                 stream_cb: Optional[Callable] = None) -> List[List[int]]:
        """Static-batch generation: one host sync per call.

        ``stream_cb(row, tokens, done)`` opts into streaming: it fires once
        per row per step with the newly committed tokens (one token on a
        plain engine, a verified block of up to K+1 on a spec engine) and
        trades the single sync for one per step.  Streamed tokens are the
        fused path's tokens.  ``extra_batch`` (the vlm/encdec families'
        inputs) raises until those families are ported."""
        toks, lens = self._check_call(prompts, max_new_tokens, extra_batch)
        if self.spec is not None:
            return self._generate_spec(toks, lens, prompts, max_new_tokens,
                                       stream_cb)
        if stream_cb is not None:
            return self._token_loop(toks, lens, prompts, max_new_tokens,
                                    stream_cb)
        cfg, dev = self.cfg, self.device
        b = len(prompts)
        logits, state = self._prefill_call(toks, lens, prompts,
                                           max_new_tokens)
        gen = self._generator()
        with self._region_timer(DECODE_REGION):
            out = torch.zeros((b, max_new_tokens), dtype=torch.int32,
                              device=dev)
            done = torch.zeros((b,), dtype=torch.bool, device=dev)
            n = torch.zeros((b,), dtype=torch.int32, device=dev)
            for t in range(max_new_tokens):
                nxt = self._sample(logits, gen)
                emit = ~done
                out[:, t] = torch.where(emit, nxt, 0)
                n += emit.to(torch.int32)
                if cfg.eos_token >= 0:
                    done |= emit & (nxt == cfg.eos_token)
                if t + 1 < max_new_tokens:  # the last logits go unused
                    logits, state = self.lm.decode_step(nxt[:, None], state)
            host = self._fetch(torch.cat([out, n[:, None]], dim=1))
        return [host[i, :host[i, -1]].tolist() for i in range(b)]

    @torch.inference_mode()
    def generate_reference(self, prompts: Sequence[Sequence[int]],
                           max_new_tokens: int = 32,
                           extra_batch: Optional[Mapping[str, Any]] = None
                           ) -> List[List[int]]:
        """The per-token loop: one sample and one host sync per generated
        token, stopping once every row is done — the fused loop's oracle
        and the serving benches' baseline.

        The JAX package's loop runs pads as context over a dense
        ``max_seq`` cache (its oracle on equal-length prompts); the port's
        starts from ``generate``'s own prefill and draws the same ``[B, V]``
        per step, so it returns ``generate``'s tokens on ragged prompts
        too, greedy and sampled."""
        toks, lens = self._check_call(prompts, max_new_tokens, extra_batch)
        return self._token_loop(toks, lens, prompts, max_new_tokens, None)

    def _token_loop(self, toks: np.ndarray, lens: np.ndarray,
                    prompts: Sequence[Sequence[int]], max_new: int,
                    stream_cb: Optional[Callable]) -> List[List[int]]:
        """The host-stepped loop behind ``generate_reference`` and plain
        streaming (the JAX engine's ``_generate_stream``): a callback per
        row per token when ``stream_cb`` is given."""
        cfg = self.cfg
        b = len(prompts)
        logits, state = self._prefill_call(toks, lens, prompts, max_new)
        gen = self._generator()
        out: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        with self._region_timer(DECODE_REGION):
            for _t in range(max_new):
                nxt = self._sample(logits, gen)
                nxt_np = self._fetch(nxt)       # per-token sync (the point)
                for i in range(b):
                    if done[i]:
                        continue
                    out[i].append(int(nxt_np[i]))
                    if cfg.eos_token >= 0 and nxt_np[i] == cfg.eos_token:
                        done[i] = True
                    if len(out[i]) >= max_new:
                        done[i] = True
                    if stream_cb is not None:
                        stream_cb(i, [int(nxt_np[i])], bool(done[i]))
                if done.all():
                    break
                logits, state = self.lm.decode_step(nxt[:, None], state)
        return out

    # ------------------------------------- continuous-batching primitives
    def init_state(self) -> Tuple[State, torch.Tensor]:
        """The scheduler's shared decode state over ``batch_slots`` rows and
        its zeroed logits buffer."""
        cfg = self.cfg
        state = self.lm.init_decode_state(cfg.batch_slots, cfg.max_seq,
                                          **self._state_kwargs())
        logits = torch.zeros((cfg.batch_slots, self.lm.cfg.vocab),
                             dtype=self.lm.dtype, device=self.device)
        return state, logits

    def _paged_row_prefill(self, lm: LM, state: State, toks: torch.Tensor,
                           slot: int, table_row: np.ndarray,
                           prefix_len: int = 0
                           ) -> Tuple[torch.Tensor, State]:
        """Prefill ONE row of ``lm`` straight into the shared page pool: a
        one-row view of the pool takes the slot's table row, so the K/V
        land in the slot's pages; then the slot's table row and length
        are written in place.  Returns (the row's logits [1, V], state)."""
        caches = state["caches"]
        row = self._upload(np.asarray(table_row, np.int32)[None])
        row_view = caches._replace(
            page_table=row,
            length=torch.zeros((1,), dtype=torch.int32, device=self.device))
        batch = {"tokens": toks}
        if prefix_len > 0:
            batch["prefix_len"] = torch.full(
                (1,), prefix_len, dtype=torch.int32, device=self.device)
        row_logits, new_row = lm.prefill(batch, {"caches": row_view})
        pt = caches.page_table
        if pt.shape[1] < row.shape[1]:
            # a segment sliced the table to its live mix: widen it back
            # (the cut only dropped dead entries, which read as null)
            pt = torch.nn.functional.pad(pt, (0, row.shape[1] - pt.shape[1]))
            state = dict(state, caches=caches._replace(page_table=pt))
        pt[slot] = row[0]
        caches.length[slot] = new_row["caches"].length[0]
        return row_logits, state

    @torch.inference_mode()
    def prefill_slot(self, state: State, logits_buf: torch.Tensor,
                     prompt: Sequence[int], slot: int,
                     table_row: Optional[np.ndarray] = None,
                     prefix_len: int = 0) -> Tuple[State, torch.Tensor]:
        """Admission point: prefill ``prompt`` into slot ``slot`` mid-flight.

        Paged engines pass the slot's freshly allocated ``table_row``; the
        prefill runs over a one-row view that shares the pool, so the K/V
        land straight in the slot's pages, then the slot's table row,
        length and logits are written in place.  With ``prefix_len > 0``
        (prefix-cache hit) ``prompt`` is only the divergent suffix and the
        resident prefix pages are attended, not recomputed.  Dense engines
        prefill a one-row twin state at the prompt's exact length and merge
        EVERY leaf of it into the slot's row (KV, lengths and, for the
        hybrid family, the SSD state and conv tail).  No host sync: the
        tokens and table row go up asynchronously."""
        toks = self._upload(np.asarray([list(prompt)], np.int32))
        with self._region_timer(PREFILL_REGION):
            if self.paged:
                assert table_row is not None, \
                    "paged admission needs a table row"
                row_logits, state = self._paged_row_prefill(
                    self.lm, state, toks, slot, table_row, prefix_len)
            else:
                if prefix_len:
                    raise ValueError("prefix_len needs a paged engine "
                                     "(dense caches hold no shared prefix)")
                row_state = self.lm.init_decode_state(1, self.cfg.max_seq)
                row_logits, row_state = self.lm.prefill({"tokens": toks},
                                                        row_state)
                _merge_row(state, row_state, slot)
            logits_buf[slot] = row_logits[0].to(logits_buf.dtype)
        return state, logits_buf

    @torch.inference_mode()
    def copy_pages(self, state: State,
                   pairs: Sequence[Tuple[int, int]]) -> State:
        """Copy-on-write at a prefix-cache fork: page ``src -> dst`` for
        every (src, dst) pair, in every layer's K and V pools and, when
        quantized, their scale pools.  Issued on the stream before the
        suffix prefill that reads the destination page."""
        if not pairs:
            return state
        with self._region_timer(PREFILL_REGION):
            arr = self._upload(np.asarray(list(pairs), np.int64))
            src, dst = arr[:, 0], arr[:, 1]
            caches = state["caches"]
            for pool in (caches.k_pages, caches.v_pages, caches.k_scale,
                         caches.v_scale):
                if pool is not None:
                    pool[:, dst] = pool[:, src]
        return state

    @torch.inference_mode()
    def decode_segment(self, state: State, logits: torch.Tensor,
                       steps: int,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, State]:
        """``steps`` fused sample -> decode steps over all slots, with no
        host sync inside.  ``steps`` is quantized UP to a power of two
        (:meth:`quantize_steps`); the caller masks any overshoot against
        per-request budgets.  ``generator`` is the scheduler's stream
        (sampled engines; greedy ignores it), threaded through as the JAX
        engine threads its ``rng``.  Returns (tokens int32 [B, steps], the
        logits after the last step, state)."""
        steps = self.quantize_steps(steps)
        toks = torch.empty((logits.shape[0], steps), dtype=torch.int32,
                           device=self.device)
        for t in range(steps):
            nxt = self._sample(logits, generator)
            toks[:, t] = nxt
            logits, state = self.lm.decode_step(nxt[:, None], state)
        return toks, logits, state

    # ------------------------------------------------ speculative decoding
    @staticmethod
    def _with_lengths(state: State, lengths: torch.Tensor) -> State:
        """Rewrite a paged state's per-row lengths, the one length every
        layer's prefill and decode read (the rollback: rejected draft
        positions fall out of the attended window; the next round's writes
        overwrite their pages)."""
        caches = state["caches"]
        return dict(state, caches=caches._replace(
            length=lengths.to(torch.int32)))

    @torch.inference_mode()
    def draft_prefill_slot(self, dstate: State, prompt: Sequence[int],
                           slot: int, table_row: np.ndarray) -> State:
        """Admission hook: land ``prompt``'s draft KV in the draft
        namespace's pages.  No prefix sharing (draft pages never enter the
        prefix index) and the logits are thrown away: rounds derive the
        pending token from the carried TARGET logits."""
        toks = self._upload(np.asarray([list(prompt)], np.int32))
        with self._region_timer(PREFILL_REGION):
            _logits, dstate = self._paged_row_prefill(
                self.draft_lm, dstate, toks, slot, table_row)
        return dstate

    @torch.inference_mode()
    def spec_segment(self, state: State, dstate: State, logits: torch.Tensor,
                     generator: torch.Generator, spec_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                State, State]:
        """One draft -> verify -> accept -> rewind round over all rows, no
        host sync (the JAX engine's ``_spec_round``; the scheduler runs one
        a segment, ``generate`` loops it).

        Returns ``(seg [B,K+1], counts [B], logits', state', dstate')``:
        ``seg[:, 0]`` is the pending token ``y`` sampled from the carried
        logits, ``seg[:, 1:counts]`` the accepted draft tokens (``counts =
        a + 1``), and ``logits'`` carries the next round's corrected
        distribution (:mod:`repro_torch.serve.spec`).  Rows with
        ``spec_mask=False`` force ``a = 0``: one token a round.  Both
        states' pages are written in place."""
        k = self.spec.num_draft_tokens
        y = self._sample(logits, generator)
        cur_len = state["caches"].length                 # [B], y excluded
        # K+1 draft steps: the last one only lands d_K's KV, so the draft
        # cache covers every position the rewind can keep (a = K)
        cur, drafts, qlogits = y, [], []
        for _ in range(k + 1):
            lg, dstate = self.draft_lm.decode_step(cur[:, None], dstate)
            cur = self._sample(lg, generator)
            drafts.append(cur)
            qlogits.append(lg)
        draft_toks = torch.stack(drafts[:k], dim=1)      # [B,K]
        suffix = torch.cat([y[:, None], draft_toks], dim=1)
        # target verify: the WHOLE suffix in one prefill over the pages,
        # K+1 next-token distributions for one forward pass
        o, state = self.lm.prefill({"tokens": suffix, "prefix_len": cur_len},
                                   state, all_logits=True)  # [B,K+1,V]
        acc, carry = accept_speculative(
            draft_toks, torch.stack(qlogits[:k], dim=1), o, generator,
            policy=self.spec_policy, temperature=self.cfg.temperature,
            spec_mask=spec_mask)
        new_len = cur_len + acc + 1
        return (suffix, acc + 1, carry, self._with_lengths(state, new_len),
                self._with_lengths(dstate, new_len.clone()))

    def _spec_prefill(self, toks: np.ndarray, lens: np.ndarray,
                      prompts: Sequence[Sequence[int]], max_new: int
                      ) -> Tuple[torch.Tensor, State, State]:
        """Both models' call-sized paged states and prompt prefills (the
        draft's logits are thrown away)."""
        cfg = self.cfg
        b = len(prompts)
        table, num_pages = self._spec_plan(prompts, max_new)
        seq_cap = -(-(toks.shape[1] + max_new + self.spec.num_draft_tokens
                      + 1) // 32) * 32
        states = []
        for lm in (self.lm, self.draft_lm):
            st = lm.init_decode_state(
                b, seq_cap, page_size=cfg.page_size, num_pages=num_pages,
                table_width=table.shape[1], kv_dtype=self.kv_dtype)
            states.append(self.set_page_table(st, table))
        batch = {"tokens": self._upload(toks), "lengths": self._upload(lens)}
        with self._region_timer(PREFILL_REGION):
            logits, state = self.lm.prefill(batch, states[0])
            _dl, dstate = self.draft_lm.prefill(batch, states[1])
        return logits, state, dstate

    def _generate_spec(self, toks: np.ndarray, lens: np.ndarray,
                       prompts: Sequence[Sequence[int]], max_new: int,
                       stream_cb: Optional[Callable]) -> List[List[int]]:
        """Speculative generate: device-side rounds with the early-exit
        reads of the module note, or one sync and one ``stream_cb`` wave
        per round with a callback.  Sets ``self.spec_stats``."""
        logits, state, dstate = self._spec_prefill(toks, lens, prompts,
                                                   max_new)
        gen = self._generator()
        b = len(prompts)
        spec_mask = torch.ones((b,), dtype=torch.bool, device=self.device)
        with self._region_timer(DECODE_REGION):
            if stream_cb is None:
                out, rounds, prop, accn = self._spec_fused(
                    logits, state, dstate, gen, spec_mask, max_new)
            else:
                out, rounds, prop, accn = self._spec_stream(
                    logits, state, dstate, gen, spec_mask, max_new,
                    stream_cb)
        self.spec_stats = dict(proposed=prop, accepted=accn,
                               accept_rate=accn / max(prop, 1),
                               rounds=rounds)
        return out

    def _spec_fused(self, logits, state, dstate, gen, spec_mask,
                    max_new: int) -> Tuple[List[List[int]], int, int, int]:
        """The fused round loop (the JAX engine's ``_make_spec_fused``
        body): deliver through the first eos and never past the budget;
        finished rows freeze, so their lengths and carried logits stay
        put.  Returns (tokens, rounds, proposed, accepted)."""
        cfg, dev = self.cfg, self.device
        k = self.spec.num_draft_tokens
        b = logits.shape[0]
        # column max_new is a trash column for the undelivered positions
        out = torch.zeros((b, max_new + 1), dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        n = torch.zeros((b,), dtype=torch.int32, device=dev)
        prop = torch.zeros((b,), dtype=torch.int32, device=dev)
        accn = torch.zeros((b,), dtype=torch.int32, device=dev)
        j = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
        rows = torch.arange(b, device=dev)[:, None]
        min_rounds = -(-max_new // (k + 1))
        rounds = 0
        while True:
            old_len = state["caches"].length
            old_dlen = dstate["caches"].length
            old_logits = logits
            seg, counts, logits, state, dstate = self.spec_segment(
                state, dstate, logits, gen, spec_mask)
            rounds += 1
            emit = ~done
            within = j < counts[:, None]
            if cfg.eos_token >= 0:
                iseos = (seg == cfg.eos_token) & within
                first = torch.where(iseos, j, k + 1).amin(dim=1)
            else:
                first = torch.full((b,), k + 1, dtype=torch.int32,
                                   device=dev)
            # tokens delivered this round: through the first eos, and never
            # past the budget
            allowed = torch.minimum(counts, first + 1)
            inc = torch.where(emit, torch.minimum(
                allowed, (max_new - n).clamp(min=0)), 0)
            valid = j < inc[:, None]
            pos = torch.where(valid, n[:, None] + j, max_new)
            out[rows, pos.long()] = torch.where(valid, seg, 0)
            n = n + inc
            done = done | (emit & ((first < counts) | (n >= max_new)))
            # freeze finished rows: their junk rounds stop moving the
            # committed lengths and the carried logits
            state = self._with_lengths(state, torch.where(
                emit, state["caches"].length, old_len))
            dstate = self._with_lengths(dstate, torch.where(
                emit, dstate["caches"].length, old_dlen))
            logits = torch.where(emit[:, None], logits, old_logits)
            live = emit & spec_mask
            prop = prop + live.to(torch.int32) * k
            accn = accn + torch.where(live, counts - 1, 0)
            if rounds >= min_rounds:
                host = self._fetch(torch.cat(
                    [out[:, :max_new], n[:, None], done[:, None].int(),
                     prop[:, None], accn[:, None]], dim=1))
                if host[:, max_new + 1].all() or rounds >= max_new:
                    break
        toks = [host[i, :host[i, max_new]].tolist() for i in range(b)]
        return (toks, rounds, int(host[:, max_new + 2].sum()),
                int(host[:, max_new + 3].sum()))

    def _spec_stream(self, logits, state, dstate, gen, spec_mask,
                     max_new: int, stream_cb: Callable
                     ) -> Tuple[List[List[int]], int, int, int]:
        """Blockwise streaming: one round, one sync and one callback wave
        per round; ``stream_cb(row, accepted_tokens, done)`` fires once per
        row per round that delivered tokens."""
        cfg = self.cfg
        k = self.spec.num_draft_tokens
        b = logits.shape[0]
        outs: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        proposed = accepted = rounds = 0
        for _round in range(max_new):
            if done.all():
                break
            seg, counts, logits, state, dstate = self.spec_segment(
                state, dstate, logits, gen, spec_mask)
            rounds += 1
            host = self._fetch(torch.cat([seg, counts[:, None]], dim=1))
            for i in range(b):
                if done[i]:
                    continue
                proposed += k
                accepted += int(host[i, -1]) - 1
                take = host[i, :host[i, -1]][:max_new - len(outs[i])]
                if cfg.eos_token >= 0:
                    hits = np.nonzero(take == cfg.eos_token)[0]
                    if hits.size:
                        take = take[:hits[0] + 1]
                        done[i] = True
                outs[i].extend(int(t) for t in take)
                if len(outs[i]) >= max_new:
                    done[i] = True
                if take.size:
                    stream_cb(i, [int(t) for t in take], bool(done[i]))
        return outs, rounds, proposed, accepted

    # ----------------------------------------------------- instrumentation
    @torch.inference_mode()
    def instrument(self, perfctr: Any, prompt_len: int = 16) -> None:
        """Attach a :class:`repro_torch.core.perfctr.PerfCtr` and probe the
        serving regions.

        The JAX tool reads ``serve.prefill`` / ``serve.decode`` events from
        compiled artifacts without running them; the port's
        ``PerfCtr.probe`` executes what it measures (the documented
        departure of ``core/perfctr.py``).  So the probes run
        ``lm.prefill`` on ``prompt_len`` tokens and ``lm.decode_step`` on a
        THROWAWAY decode state of ``batch_slots`` rows (the probed prefill
        writes its state in place: never the engine's or a scheduler's).
        From then on every ``generate``, ``generate_reference`` and
        scheduler segment accumulates into the same regions through
        ``PerfCtr.region_timer``."""
        self.perfctr = perfctr
        cfg = self.cfg
        b = cfg.batch_slots
        state = self.lm.init_decode_state(b, cfg.max_seq,
                                          **self._state_kwargs())
        toks = torch.zeros((b, prompt_len), dtype=torch.int32,
                           device=self.device)
        with perfctr.marker(PREFILL_REGION):
            perfctr.probe(self.lm.prefill, {"tokens": toks}, state,
                          repeats=1)
        with perfctr.marker(DECODE_REGION):
            perfctr.probe(self.lm.decode_step, toks[:, :1], state,
                          repeats=1)

    def restore(self, path: str, **scheduler_kwargs) -> "BatchScheduler":
        """Rebuild a :class:`BatchScheduler` from a serving snapshot
        written by a previous run, of this package or the JAX one (crash
        recovery / planned restart).  See :meth:`BatchScheduler.restore`
        for the parity contract."""
        return BatchScheduler.restore(self, path, **scheduler_kwargs)


def _merge_row(big: Any, row: Any, slot: int) -> None:
    """Scatter a one-row decode state into row ``slot`` of ``big``, in
    place, leaf by leaf (the JAX engine's ``_merge_impl``).  Every leaf is
    ``[layers, B, ...]`` except the per-row lengths ``[B]``."""
    if isinstance(big, torch.Tensor):
        axis = 0 if big.dim() == 1 else 1
        big.select(axis, slot).copy_(row.select(axis, 0))
    elif isinstance(big, Mapping):
        for key in big:
            _merge_row(big[key], row[key], slot)
    else:                                   # tuples and NamedTuples
        for b_leaf, r_leaf in zip(big, row):
            _merge_row(b_leaf, r_leaf, slot)


class BatchScheduler:
    """True continuous batching over an Engine's shared decode state.

    A slot table of ``batch_slots`` rows.  Decode runs in multi-token
    segments (power-of-two quantized, at most ``admission_chunk`` steps; a
    segment may overshoot the tightest remaining budget by a few on-device
    tokens, but retire masks every row against its own ``max_new_tokens``
    — no token is ever RETURNED past a request's budget).  After each
    segment ONE host sync fetches the segment's tokens; finished rows (eos
    or budget) release their slots immediately and queued requests
    prefill into the freed slots at their exact prompt length before the
    next segment — no full-batch barrier, no wave drains.

    On a paged engine (``ServeConfig.page_size > 0``) the scheduler also
    drives the KV pool (:class:`repro_torch.serve.kv_pool.KVPool`):
    admission maps resident shared-prefix pages read-only (copy-on-write at
    the fork page), allocates the rest of the context and RESERVES the
    request's worst case (deferring when the pool cannot promise it —
    backpressure instead of overcommit); each segment pre-extends active
    rows to cover its writes and uploads a page table sliced to the live
    mix; retirement returns the pages, keeping indexed prefix pages for
    future hits.

    On a spec engine every segment is ONE spec round over all slots (rows
    with ``Request.spec`` draft; the others commit one token a round), and
    each row's draft twin holds pages in the pool's second namespace:
    reserved and allocated at admission, released with the row, audited by
    :meth:`check`.  ``metrics`` gains ``spec_rounds``, ``draft_proposed``
    and ``draft_accepted``.

    Request-plane robustness, as in the JAX scheduler: bounded admission
    (:class:`repro_torch.serve.admission.AdmissionQueue`: ``max_queue``,
    ``shed_policy``, bounded head-of-line bypass), priorities, deadlines
    and cancellation (expired or cancelled rows retire at the next segment
    boundary, the segment's tokens for them discarded, the event recorded
    in ``ft_events``), :meth:`drain`, and ``run(max_segments=N)`` with
    active requests re-queued with their progress.  Every segment's wall
    time feeds a straggler detector.

    With ``snapshot_dir`` set, a crash-safe serving snapshot (queue,
    progress, the prefix index and its pages' contents) is written every
    ``snapshot_every`` segments and at exit, keeping the newest
    ``snapshot_keep``; :meth:`restore` rebuilds a scheduler from one, of
    this package or the JAX one.  A
    :class:`repro_torch.ft.chaos.ChaosSchedule` passed as ``chaos`` is
    ticked at every segment boundary (fault injection with invariant
    checks).  The port serves on one card: ``heartbeats`` is None, so
    chaos's flap and death events take their single-device skip (the
    mesh and ``inject_failure`` are ``ROADMAP.md`` queue 1 item 14).
    """

    def __init__(self, engine: Engine,
                 admission_chunk: Optional[int] = None,
                 straggler_threshold: float = 4.0,
                 straggler_min_ratio: float = 1.5,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new",
                 max_bypass: int = 4,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0, snapshot_keep: int = 3,
                 chaos: Any = None):
        self.engine = engine
        self.admission_chunk = (admission_chunk
                                or engine.cfg.admission_chunk)
        self.queue = AdmissionQueue(max_queue=max_queue,
                                    shed_policy=shed_policy,
                                    max_bypass=max_bypass)
        self.max_bypass = int(max_bypass)
        self.requests: Dict[int, Request] = {}   # every submitted rid
        self.completed: Dict[int, Request] = {}
        self.aborted: Dict[int, Request] = {}    # expired/cancelled/shed
        self.metrics: Dict[str, float] = {
            "segments": 0, "admissions": 0, "decode_steps": 0,
            # prefix-cache telemetry (paged engines; zero otherwise)
            "prefix_hits": 0,        # admissions with a non-empty match
            "prompt_tokens": 0,      # total prompt tokens submitted
            "prefilled_tokens": 0,   # tokens actually prefilled (suffixes)
            "pages_shared": 0,       # full prefix pages mapped read-only
            "cow_copies": 0,         # copy-on-write page copies issued
            # request-plane robustness telemetry
            "expired": 0, "cancelled": 0, "sheds": 0, "rejections": 0,
            "bypasses": 0, "snapshots": 0, "restores": 0,
        }
        if engine.spec is not None:
            # speculative decoding telemetry (accept rate =
            # draft_accepted / draft_proposed over spec rows)
            self.metrics.update(spec_rounds=0, draft_proposed=0,
                                draft_accepted=0)
        self.admission_log: List[Tuple[int, int]] = []   # (rid, slot)
        self.pool: Optional[kv_pool.KVPool] = None   # per run(), paged only
        self.draining = False
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self.snapshot_keep = int(snapshot_keep)
        self.chaos = chaos
        self._running = False
        self._wall_inflate = 1.0       # chaos slow/hung segment multiplier
        self._restore_index = None     # pool index payload from restore()
        # live run state (instance attrs so drain()/check() can see them
        # between segments; only meaningful while _running)
        self._slots: List[Optional[Request]] = []
        self._remaining = np.zeros(0, np.int64)
        self._slot_len = np.zeros(0, np.int64)
        self.ft_events: List[Dict[str, Any]] = []
        # segment walls feed the straggler detector on every engine
        self.straggler = StragglerDetector(threshold=straggler_threshold,
                                           min_ratio=straggler_min_ratio)
        # one card, no heartbeats: chaos's heartbeat_flap and device_death
        # events see None and record their single-device skip
        self.heartbeats = None

    def submit(self, req: Request) -> None:
        """Queue one request, or refuse it in O(1).

        Raises ValueError on malformed requests and
        :class:`repro_torch.serve.admission.AdmissionRejected` — carrying a
        structured, usually retryable :class:`Rejection` — when the
        bounded queue refuses the arrival (``reason="queue_full"``), the
        scheduler is draining, or ``shed-lowest`` found nothing less
        urgent to evict.  A successful push may instead shed a queued
        lower-priority request; the victim lands in ``aborted`` with
        ``status="shed"`` and an ft event."""
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if len(req.prompt) + req.max_new_tokens > self.engine.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + max_new "
                f"({req.max_new_tokens}) exceeds max_seq "
                f"({self.engine.cfg.max_seq})")
        req.submit_time = time.perf_counter()
        self.requests[req.rid] = req
        try:
            victim = self.queue.push(req)
        except AdmissionRejected as e:
            req.status = "rejected"
            self.metrics["rejections"] += 1
            self.ft_events.append(dict(
                type="reject", rid=req.rid, reason=e.rejection.reason,
                retryable=e.rejection.retryable,
                retry_after_s=e.rejection.retry_after_s,
                segment=int(self.metrics["segments"])))
            raise
        req.status = "queued"
        if victim is not None:
            victim.status = "shed"
            self.aborted[victim.rid] = victim
            self.metrics["sheds"] += 1
            self.ft_events.append(dict(
                type="shed", rid=victim.rid, priority=victim.priority,
                by_rid=req.rid, segment=int(self.metrics["segments"])))

    def cancel(self, rid: int) -> bool:
        """Host-side cancellation: flag ``rid`` for retirement at the next
        segment boundary (queued requests are dequeued immediately when no
        run is active).  Returns False for unknown/already-terminal rids —
        cancelling a finished request is a no-op, not an error."""
        req = self.requests.get(rid)
        if req is None or req.terminal:
            return False
        req.cancel_requested = True
        if not self._running and self.queue.remove(req):
            self._finish_abnormal(req, "cancel")
        return True

    def drain(self) -> Dict[int, Request]:
        """Graceful drain: stop admission, finish accepted work.

        Future submits are refused (``reason="draining"``, not retryable
        — the process is going away); requests already queued or
        in-flight run to completion, and with ``snapshot_dir`` set a
        final snapshot is written on exit.  Returns ``completed``."""
        self.draining = True
        self.queue.close()
        if not self._running:
            return self.run()
        return self.completed

    # --------------------------------------------- lifecycle bookkeeping
    def _expiry_reason(self, req: Request, now: float) -> Optional[str]:
        """Why ``req`` should be expired at this boundary, or None."""
        age_ms = (now - req.submit_time) * 1e3
        if req.deadline_ms is not None and age_ms > req.deadline_ms:
            return "deadline"
        if (req.ttft_deadline_ms is not None and not req.first_token_time
                and age_ms > req.ttft_deadline_ms):
            return "ttft_deadline"
        return None

    def _finish_abnormal(self, req: Request, reason: str) -> None:
        """Terminal bookkeeping for a cancelled/expired request: it never
        reaches ``completed`` and gains no further tokens (tokens already
        delivered in earlier segments stay — they were observable)."""
        req.status = "cancelled" if reason == "cancel" else "expired"
        self.aborted[req.rid] = req
        kind = "cancel" if reason == "cancel" else "expiry"
        self.metrics["cancelled" if reason == "cancel" else "expired"] += 1
        self.ft_events.append(dict(
            type=kind, rid=req.rid, reason=reason,
            generated=len(req.generated),
            segment=int(self.metrics["segments"])))

    def _release_slot(self, i: int) -> None:
        self._slots[i] = None
        self._remaining[i] = 0
        self._slot_len[i] = 0
        if self.pool is not None:
            self.pool.release(i)
            if self.engine.spec is not None:
                # the row's draft-namespace twin goes with it: a leaked
                # draft page would strand pool pages (KVPool.check() audits
                # the shared free list across both namespaces)
                self.pool.release(self.engine.cfg.batch_slots + i)

    def _sweep_queue(self, now: float) -> None:
        """Drop cancelled/expired requests before they ever prefill."""
        for req in list(self.queue.ordered()):
            reason = ("cancel" if req.cancel_requested
                      else self._expiry_reason(req, now))
            if reason:
                self.queue.remove(req)
                self._finish_abnormal(req, reason)

    def _fits(self, req: Request) -> bool:
        """Could ``req`` reserve its worst case right now?  (Resume
        requests measure prompt + progress.)"""
        if self.pool is None:
            return True
        full_len = len(req.prompt) + len(req.generated)
        worst = (full_len + (req.max_new_tokens - len(req.generated))
                 + self.engine.slot_headroom)
        _, shared = self.pool.match_prefix(req.prompt + req.generated)
        if self.engine.spec is not None:
            # spec engines admit into BOTH namespaces: the draft twin
            # reserves the same worst case with no prefix sharing
            per_ns = min(kv_pool.pages_for(worst, self.pool.page_size),
                         self.pool.table_width)
            return (2 * per_ns - shared) <= self.pool.unpromised()
        return self.pool.can_reserve(worst, shared_pages=shared)

    def _pick_admission(self) -> Optional[Request]:
        """Next admissible queued request under the bounded-bypass rule:
        priority-FIFO order, but once the head has been bypassed
        ``max_bypass`` times the queue blocks until the head fits."""
        head = self.queue.head()
        if head is None:
            return None
        for idx, req in enumerate(self.queue.ordered()):
            if self._fits(req):
                if idx > 0:
                    self.queue.note_bypass(head)
                    self.metrics["bypasses"] += 1
                return req
            if idx == 0 and self.queue.bypasses(head) >= self.max_bypass:
                return None           # head blocked: let pages drain to it
        return None

    def check(self) -> None:
        """Scheduler-level invariants (the chaos harness calls this after
        every injected event, on top of ``KVPool.check``)."""
        live = {r.rid for r in self._slots if r is not None}
        queued = {r.rid for r in self.queue.ordered()}
        done = set(self.completed)
        dead = set(self.aborted)
        for a, b, what in ((live, queued, "active+queued"),
                           (live, done, "active+completed"),
                           (live, dead, "active+aborted"),
                           (queued, done, "queued+completed"),
                           (queued, dead, "queued+aborted"),
                           (done, dead, "completed+aborted")):
            assert not (a & b), f"request in two states ({what}): {a & b}"
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            assert req.status == "active", \
                f"slot {i}: status {req.status!r} while resident"
            assert len(req.generated) <= req.max_new_tokens, \
                f"slot {i}: generated past budget"
            if self.pool is not None:
                assert self.pool.slot_pages(i) > 0, \
                    f"slot {i}: active with no pages"
                if self.engine.spec is not None:
                    ds = self.engine.cfg.batch_slots + i
                    assert self.pool.slot_pages(ds) > 0, \
                        f"slot {i}: active with no draft pages"
        for rid in done:
            assert self.completed[rid].status == "done", \
                f"completed request {rid} has status " \
                f"{self.completed[rid].status!r}"
        if self.pool is not None:
            self.pool.check()

    # ------------------------------------------------ crash-safe snapshots
    @staticmethod
    def _req_to_dict(req: Request) -> Dict[str, Any]:
        return dict(rid=req.rid, prompt=list(req.prompt),
                    generated=list(req.generated),
                    max_new_tokens=req.max_new_tokens,
                    priority=req.priority, deadline_ms=req.deadline_ms,
                    ttft_deadline_ms=req.ttft_deadline_ms,
                    status=req.status, finished=req.finished,
                    spec=req.spec)

    @staticmethod
    def _req_from_dict(d: Dict[str, Any]) -> Request:
        return Request(rid=int(d["rid"]), prompt=list(d["prompt"]),
                       generated=list(d["generated"]),
                       max_new_tokens=int(d["max_new_tokens"]),
                       priority=int(d.get("priority", 1)),
                       deadline_ms=d.get("deadline_ms"),
                       ttft_deadline_ms=d.get("ttft_deadline_ms"),
                       status=str(d.get("status", "queued")),
                       finished=bool(d.get("finished", False)),
                       spec=bool(d.get("spec", False)))

    def _snapshot_config(self) -> Dict[str, Any]:
        """The engine settings a restore must match (the JAX scheduler's
        keys and values, so either package checks the other's)."""
        eng = self.engine
        cfg = eng.cfg
        return dict(max_seq=cfg.max_seq, batch_slots=cfg.batch_slots,
                    temperature=cfg.temperature, eos_token=cfg.eos_token,
                    seed=cfg.seed, page_size=cfg.page_size,
                    kv_dtype=cfg.kv_dtype, prefix_cache=cfg.prefix_cache,
                    pool_pages=eng.pool_pages if eng.paged else None,
                    vocab=eng.lm.cfg.vocab,
                    spec=(eng.spec.signature() if eng.spec is not None
                          else None))

    def _export_index(self, state: State) -> Optional[Dict[str, Any]]:
        """Serialize the prefix trie + its device page CONTENTS — the
        part of the KV state a restore can reuse without recompute.  The
        pages come to the host in one audited transfer (``_fetch``)."""
        if self.pool is None or not self.engine.cfg.prefix_cache:
            return None
        nodes = self.pool.export_index()
        if not nodes:
            return None
        ids = [n["page"] for n in nodes]
        caches = state["caches"]
        idx = self.engine._upload(np.asarray(ids, np.int64))
        fetch = {"k": caches.k_pages[:, idx], "v": caches.v_pages[:, idx]}
        if caches.k_scale is not None:
            fetch["k_scale"] = caches.k_scale[:, idx]
            fetch["v_scale"] = caches.v_scale[:, idx]
        pages: Dict[str, Any] = dict(self.engine._fetch(fetch))
        pages["ids"] = ids
        return {"nodes": nodes, "pages": pages}

    def _write_snapshot(self, state: Optional[State],
                        reason: str = "interval") -> Optional[str]:
        """Atomically persist the request plane (``store.
        save_serving_snapshot``): every non-terminal request with its
        progress, completed/aborted outcomes, metrics/events, and the
        reusable prefix-page contents; then drop all but the newest
        ``snapshot_keep``.  The ``snapshot`` event also carries the
        index's page count (0: no index, no transfer)."""
        if not self.snapshot_dir:
            return None
        seg = int(self.metrics["segments"])
        # pending order: in-flight first (by admission order), then queue
        order = {rid: k for k, (rid, _s) in enumerate(self.admission_log)}
        inflight = sorted((r for r in self._slots if r is not None),
                          key=lambda r: order.get(r.rid, 0))
        pending = [self._req_to_dict(r)
                   for r in list(inflight) + list(self.queue.ordered())]
        index = self._export_index(state) if state is not None else None
        payload = dict(
            config=self._snapshot_config(), segment=seg, reason=reason,
            pending=pending,
            completed=[self._req_to_dict(r)
                       for r in self.completed.values()],
            aborted=[self._req_to_dict(r) for r in self.aborted.values()],
            metrics=dict(self.metrics), ft_events=list(self.ft_events),
            index=index)
        path = os.path.join(self.snapshot_dir, f"snap_{seg:08d}.snap")
        store.save_serving_snapshot(path, payload)
        self.metrics["snapshots"] += 1
        self.ft_events.append(dict(
            type="snapshot", segment=seg, path=path, reason=reason,
            pending=len(pending),
            index_pages=len(index["pages"]["ids"]) if index else 0))
        for old in store.list_snapshots(
                self.snapshot_dir)[:-self.snapshot_keep]:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    @classmethod
    def restore(cls, engine: Engine, path: str, **kwargs
                ) -> "BatchScheduler":
        """Rebuild a scheduler from a serving snapshot (either package's).

        Non-terminal requests re-queue with their progress: at admission
        each replays ``prompt + generated`` through prefill — hitting the
        restored prefix-page index for everything the snapshot retained
        (those tokens never recompute), replaying from the prompt for the
        rest — then decodes its remaining budget.  fp32 greedy tokens
        equal an uninterrupted run's.  Completed/aborted outcomes are
        pre-populated; deadlines restart from restore time (wall clocks
        don't survive a process).

        Raises :class:`repro_torch.checkpoint.SnapshotCorrupt` on a
        damaged file and ValueError when the snapshot's engine config is
        incompatible (different ``max_seq``/``page_size``/sampling/spec —
        the tokens could not match).  A pool-size mismatch only drops the
        page index (replay instead of resume)."""
        snap = store.load_serving_snapshot(path)
        sc = snap.get("config", {})
        cfg = engine.cfg
        for key, actual in (("max_seq", cfg.max_seq),
                            ("page_size", cfg.page_size),
                            ("temperature", cfg.temperature),
                            ("eos_token", cfg.eos_token),
                            ("seed", cfg.seed),
                            ("vocab", engine.lm.cfg.vocab)):
            if sc.get(key) != actual:
                raise ValueError(
                    f"snapshot {path}: config mismatch on {key!r} "
                    f"(snapshot {sc.get(key)!r} != engine {actual!r})")
        snap_spec = sc.get("spec")
        eng_spec = (engine.spec.signature() if engine.spec is not None
                    else None)
        if ((tuple(snap_spec) if snap_spec else None)
                != (tuple(eng_spec) if eng_spec else None)):
            raise ValueError(
                f"snapshot {path}: config mismatch on 'spec' "
                f"(snapshot {snap_spec!r} != engine {eng_spec!r}) — "
                f"restoring under a different draft pairing could not "
                f"reproduce the token stream")
        sched = cls(engine, **kwargs)
        now = time.perf_counter()
        for d in snap.get("completed", []):
            req = cls._req_from_dict(d)
            sched.completed[req.rid] = req
            sched.requests[req.rid] = req
        for d in snap.get("aborted", []):
            req = cls._req_from_dict(d)
            sched.aborted[req.rid] = req
            sched.requests[req.rid] = req
        pending = [cls._req_from_dict(d) for d in snap.get("pending", [])]
        for req in reversed(pending):
            req.status = "queued"
            req.submit_time = now
            sched.requests[req.rid] = req
            sched.queue.push_front(req)
        index = snap.get("index")
        if index and engine.paged and (
                sc.get("pool_pages") != engine.pool_pages
                or not cfg.prefix_cache):
            index = None                  # page ids invalid: full replay
        sched._restore_index = index if engine.paged else None
        sched.metrics["restores"] += 1
        sched.ft_events.append(dict(
            type="restore", path=path,
            snapshot_segment=int(snap.get("segment", 0)),
            pending=len(pending),
            index_pages=(len(index["pages"]["ids"]) if index else 0)))
        return sched

    def _apply_restore_index(self, state: State) -> State:
        """Adopt the snapshot's prefix trie into the fresh pool and write
        the saved page contents into the pool's tensors on the engine's
        device, in place (before the first admission)."""
        index, self._restore_index = self._restore_index, None
        if not index or self.pool is None:
            return state
        if not self.pool.adopt_index(index["nodes"]):
            return state
        pages = index["pages"]
        eng = self.engine
        idx = eng._upload(np.asarray(pages["ids"], np.int64))
        caches = state["caches"]
        for pool, key in ((caches.k_pages, "k"), (caches.v_pages, "v"),
                          (caches.k_scale, "k_scale"),
                          (caches.v_scale, "v_scale")):
            vals = pages.get(key)
            if pool is None or vals is None:
                continue
            if isinstance(vals, np.ndarray):     # read-only frombuffer view
                vals = torch.from_numpy(vals.copy())
            pool[:, idx] = vals.to(device=eng.device, dtype=pool.dtype)
        return state

    def _requeue_active(self) -> int:
        """Push every in-flight request back onto the queue with its
        progress (earliest-admitted ends up at the head), releasing slots
        and pages — the ``run(max_segments=...)`` early-exit path."""
        order = {rid: k for k, (rid, _s) in enumerate(self.admission_log)}
        live = [(order.get(r.rid, 0), i, r)
                for i, r in enumerate(self._slots) if r is not None]
        for _, i, req in sorted(live, reverse=True):
            self._release_slot(int(i))
            req.status = "queued"
            self.queue.push_front(req)
        return len(live)

    def _admit(self, i: int, req: Request, state: State,
               dstate: Optional[State], logits: torch.Tensor
               ) -> Tuple[State, Optional[State], torch.Tensor]:
        """Admit ``req`` into free slot ``i``: map its shared prefix,
        reserve and allocate its pages (and its draft twin's on a spec
        engine), copy the fork page, prefill the rest (JAX ``run()``'s
        admission block)."""
        eng = self.engine
        nslots = eng.cfg.batch_slots
        full = list(req.prompt) + list(req.generated)
        budget = req.max_new_tokens - len(req.generated)
        table_row = None
        prefix_len = 0
        if self.pool is not None:
            # exactly ceil(len/page) pages for the context (minus full-page
            # prefix hits, mapped read-only by refcount bump) and a
            # RESERVATION of the worst case (budget + segment overshoot);
            # _pick_admission already proved can_reserve for it
            worst = len(full) + budget + eng.slot_headroom
            admit = self.pool.admit_prefix(i, full)
            prefix_len = admit.matched_len
            cow_pairs = [admit.cow] if admit.cow is not None else []
            self.pool.reserve(i, worst)
            self.pool.alloc(i, len(full))
            table_row = self.pool.tables[i]
            if eng.spec is not None:
                # the draft twin: full context, no sharing
                self.pool.reserve(nslots + i, worst)
                self.pool.alloc(nslots + i, len(full))
            # the fork page must hold the shared tokens before the suffix
            # prefill reads (and partially rewrites) it: the copy is
            # issued first, in stream order
            state = eng.copy_pages(state, cow_pairs)
            self.metrics["prefix_hits"] += int(prefix_len > 0)
            self.metrics["pages_shared"] += admit.shared_full
            self.metrics["cow_copies"] += len(cow_pairs)
        self.queue.remove(req)
        # resume path (restore / max_segments re-queue): ``full`` replays
        # prompt + progress through prefill — resident prefix pages are
        # attended, not recomputed — and the row decodes its remaining
        # budget
        state, logits = eng.prefill_slot(state, logits, full[prefix_len:], i,
                                         table_row=table_row,
                                         prefix_len=prefix_len)
        if eng.spec is not None:
            dstate = eng.draft_prefill_slot(dstate, full, i,
                                            self.pool.tables[nslots + i])
        if self.pool is not None:
            # index the now-resident context pages for the NEXT admission
            self.pool.register_prefix(i, full)
        req.status = "active"
        self._slots[i] = req
        self._remaining[i] = budget
        self._slot_len[i] = len(full)
        self.metrics["admissions"] += 1
        self.metrics["prompt_tokens"] += len(full)
        self.metrics["prefilled_tokens"] += len(full) - prefix_len
        self.admission_log.append((req.rid, i))
        return state, dstate, logits

    def _retire(self, i: int, toks: np.ndarray, produced: int,
                now: float) -> None:
        """Retire or extend slot ``i`` after a segment: cancelled/expired
        rows release their slot with the segment's tokens DISCARDED;
        others take at most their remaining budget (overshoot masked),
        cut at eos."""
        cfg = self.engine.cfg
        req = self._slots[i]
        reason = ("cancel" if req.cancel_requested
                  else self._expiry_reason(req, now))
        if reason:
            self._release_slot(i)
            self._finish_abnormal(req, reason)
            return
        if not req.generated and not req.first_token_time:
            req.first_token_time = now
        take = toks[:min(produced, self._remaining[i])]
        finished = False
        if cfg.eos_token >= 0:
            hits = np.nonzero(take == cfg.eos_token)[0]
            if hits.size:
                take = take[:hits[0] + 1]
                finished = True
        req.generated.extend(int(t) for t in take)
        self._remaining[i] = req.max_new_tokens - len(req.generated)
        if finished or self._remaining[i] <= 0:
            req.finished = True
            req.status = "done"
            self.completed[req.rid] = req
            self._release_slot(i)
            self.queue.note_service_time(now - req.submit_time)

    @torch.inference_mode()
    def run(self, max_segments: Optional[int] = None) -> Dict[int, Request]:
        """Drive the queue to completion (or for ``max_segments`` decode
        segments — in-flight requests then re-queue with their progress
        kept, and with ``snapshot_dir`` set an exit snapshot is written:
        the controlled half of the kill-and-restore story).  One
        ``torch.Generator`` seeded from ``ServeConfig.seed`` feeds every
        sampled segment of the run."""
        eng, cfg = self.engine, self.engine.cfg
        if not self.queue:
            return self.completed
        nslots = cfg.batch_slots
        spec = eng.spec
        if eng.paged:
            # spec engines run TWO page namespaces over one free list: pool
            # slot i is row i's target pages, slot nslots+i its draft pages
            # (never indexed in the prefix trie)
            pool_slots = 2 * nslots if spec is not None else nslots
            self.pool = kv_pool.KVPool(eng.pool_pages, cfg.page_size,
                                       pool_slots, eng.table_width,
                                       prefix_cache=cfg.prefix_cache)
        state, logits = eng.init_state()
        dstate = None
        if spec is not None:
            dstate = eng.draft_lm.init_decode_state(nslots, cfg.max_seq,
                                                    **eng._state_kwargs())
        gen = eng._generator()
        state = self._apply_restore_index(state)
        slots = self._slots = [None] * nslots
        remaining = self._remaining = np.zeros(nslots, np.int64)
        # device-side row length (includes segment overshoot the request
        # never sees — the page a token was WRITTEN to must stay covered)
        slot_len = self._slot_len = np.zeros(nslots, np.int64)
        self._running = True
        seg_run = 0     # segments executed by THIS call (max_segments)

        try:
            while self.queue or any(s is not None for s in slots):
                # cancelled/expired requests never reach a slot
                self._sweep_queue(time.perf_counter())
                # ---- admission: freed slots take queued requests
                # mid-flight, in (priority, arrival) order with bounded
                # head-of-line bypass
                for i in range(nslots):
                    if slots[i] is not None:
                        continue
                    req = self._pick_admission()
                    if req is None:
                        break
                    state, dstate, logits = self._admit(i, req, state,
                                                        dstate, logits)

                active = np.array([s is not None for s in slots])
                if not active.any():
                    if not self.queue:
                        break
                    if self.pool is not None and self.pool.seized:
                        # chaos pool exhaustion starved admission dry:
                        # return the seized pages rather than deadlock
                        freed = self.pool.unseize()
                        self.ft_events.append(dict(
                            type="pool_relief", pages=freed,
                            segment=int(self.metrics["segments"])))
                        continue
                    raise RuntimeError(
                        f"request {self.queue.head().rid}: needs more pages "
                        f"than the whole pool can promise ({self.pool!r})")
                live = np.nonzero(active)[0]
                if spec is not None:
                    # one spec round per segment: a row's device length can
                    # grow by up to K+1 (exactly counts[i], fetched below);
                    # cover BOTH namespaces first, then slice both tables
                    # to the bucket the live mix needs
                    grow = spec.num_draft_tokens + 1
                    for i in live:
                        self.pool.ensure(int(i), int(slot_len[i]) + grow)
                        self.pool.ensure(nslots + int(i),
                                         int(slot_len[i]) + grow)
                    width = max(max(self.pool.slot_pages(int(i)),
                                    self.pool.slot_pages(nslots + int(i)))
                                for i in live)
                    bucket = min(-(-max(width, 1) // 4) * 4, eng.table_width)
                    tbl = self.pool.table()
                    state = eng.set_page_table(state, tbl[:nslots, :bucket])
                    dstate = eng.set_page_table(dstate,
                                                tbl[nslots:, :bucket])
                    spec_mask = eng._upload(np.array(
                        [s is not None and s.spec for s in slots]))
                    seg_t0 = time.perf_counter()
                    with eng._region_timer(DECODE_REGION):
                        toks, counts, logits, state, dstate = \
                            eng.spec_segment(state, dstate, logits, gen,
                                             spec_mask)
                        host = eng._fetch(torch.cat(  # ONE sync a segment
                            [toks, counts[:, None]], dim=1))
                    toks_np = host[:, :-1]
                    produced = host[:, -1].astype(np.int64)
                    self.metrics["decode_steps"] += 1
                    self.metrics["spec_rounds"] += 1
                    for i in live:
                        if slots[i].spec:
                            self.metrics["draft_proposed"] += \
                                spec.num_draft_tokens
                            self.metrics["draft_accepted"] += \
                                int(produced[i]) - 1
                else:
                    # requested steps fit the tightest active budget; the
                    # engine quantizes UP to a power of two and overshoot
                    # is masked against each request's budget at retire
                    steps = eng.quantize_steps(
                        min(self.admission_chunk,
                            int(remaining[active].min())))
                    if self.pool is not None:
                        # cover every page this segment can write, then
                        # hand the device a table sliced to the width the
                        # LIVE mix needs (x4-page buckets, as the JAX
                        # scheduler cuts them): decode reads track actual
                        # context, not max_seq.  Entries past a row's live
                        # pages are never read, so the cut only drops dead
                        # entries.
                        for i in live:
                            self.pool.ensure(int(i),
                                             int(slot_len[i]) + steps)
                        width = max(self.pool.slot_pages(int(i))
                                    for i in live)
                        bucket = min(-(-max(width, 1) // 4) * 4,
                                     eng.table_width)
                        state = eng.set_page_table(
                            state, self.pool.table()[:, :bucket])
                    seg_t0 = time.perf_counter()
                    with eng._region_timer(DECODE_REGION):
                        toks, logits, state = eng.decode_segment(
                            state, logits, steps, gen)
                        toks_np = eng._fetch(toks)  # ONE sync per segment
                    steps = toks_np.shape[1]
                    produced = np.full(nslots, steps, np.int64)
                    self.metrics["decode_steps"] += steps
                slot_len[active] += produced[active]
                self.metrics["segments"] += 1
                seg_run += 1
                now = time.perf_counter()
                # chaos slow/hung-segment injection inflates the OBSERVED
                # wall (the detector path under test) without sleeping
                seg_wall = (now - seg_t0) * self._wall_inflate
                self._wall_inflate = 1.0
                verdict = self.straggler.record(seg_wall)
                if verdict.is_straggler:
                    self.ft_events.append(dict(
                        type="straggler",
                        segment=int(self.metrics["segments"]),
                        wall_s=seg_wall, ema_s=verdict.ema))
                # ---- retire: finished/expired/cancelled rows release
                # their slots immediately (spec rows take at most their
                # accepted count)
                for i in live:
                    self._retire(int(i), toks_np[i], int(produced[i]), now)
                if (self.snapshot_dir and self.snapshot_every
                        and int(self.metrics["segments"])
                        % self.snapshot_every == 0):
                    self._write_snapshot(state)
                if self.chaos is not None:
                    self.chaos.tick(self, int(self.metrics["segments"]))
                if max_segments is not None and seg_run >= max_segments:
                    break
        finally:
            self._running = False
        requeued = self._requeue_active()
        if self.snapshot_dir:
            self._write_snapshot(
                state, reason="exit" if not requeued else "early_exit")
        return self.completed
