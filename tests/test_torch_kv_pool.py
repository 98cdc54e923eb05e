"""The port's copies of ``KVPool`` and ``AdmissionQueue`` against the
reference's own scenarios.

``repro_torch/serve/kv_pool.py`` and ``repro_torch/serve/admission.py`` are
verbatim copies of the JAX package's pure-Python modules (the port never
imports the JAX package).  Every scenario below comes from the reference's
tests (``tests/test_paged_decode.py``, ``tests/test_prefix_cache.py``,
``tests/test_robustness.py``) and runs unchanged against BOTH
implementations, including ``KVPool.check()`` after every step of random
churn; a last test replays one churn trace through both and compares
every observable step for step.
"""

import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.serve import admission as jax_admission
from repro.serve import kv_pool as jax_kv_pool
from repro.serve.engine import Request as JaxRequest
from repro_torch.serve import admission, kv_pool
from repro_torch.serve.engine import Request

torch.set_num_threads(1)

IMPLS = {
    "jax": types.SimpleNamespace(pool=jax_kv_pool, adm=jax_admission,
                                 Request=JaxRequest),
    "torch": types.SimpleNamespace(pool=kv_pool, adm=admission,
                                   Request=Request),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# ---------------------------------------------------------------------------
# the pool: no double-alloc, no leaks, churn-proof
# ---------------------------------------------------------------------------

def test_pool_alloc_release_invariants(impl):
    pool = impl.pool.KVPool(num_pages=17, page_size=8, slots=3,
                            table_width=5)
    pool.check()
    assert pool.available() == 16
    assert pool.alloc(0, 20) == impl.pool.pages_for(20, 8) == 3
    assert pool.alloc(1, 8) == 1
    pool.check()
    assert pool.ensure(0, 24) == 0
    assert pool.ensure(0, 25) == 1
    pool.check()
    assert pool.slot_pages(0) == 4 and pool.slot_pages(1) == 1
    assert (pool.tables[0, :4] > 0).all() and pool.tables[0, 4] == 0
    assert pool.release(0) == 4
    pool.check()
    assert pool.release(0) == 0          # idempotent, no double-free
    assert pool.release(1) == 1
    pool.check()
    assert pool.all_free()


def test_pool_reservation_gates_future_growth(impl):
    pool = impl.pool.KVPool(num_pages=9, page_size=8, slots=2, table_width=5)
    pool.reserve(0, 32)                      # promise 4 pages
    pool.alloc(0, 8)                         # but only 1 allocated yet
    assert pool.available() == 7
    assert pool.unpromised() == 4            # 3 are spoken for
    assert pool.can_reserve(32)
    assert not pool.can_reserve(33)
    pool.ensure(0, 32)
    pool.check()
    pool.release(0)
    assert pool.unpromised() == 8


def test_pool_exhaustion_and_overflow_errors(impl):
    pool = impl.pool.KVPool(num_pages=4, page_size=8, slots=2, table_width=2)
    assert pool.can_fit(16, 0)
    pool.alloc(0, 16)
    assert not pool.can_fit(16, 1)           # only 1 page left
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1, 16)
    with pytest.raises(ValueError, match="table_width"):
        pool.ensure(0, 8 * 3)
    with pytest.raises(ValueError, match="null page"):
        impl.pool.KVPool(num_pages=1, page_size=8, slots=1, table_width=1)


def test_pool_churn_is_leak_free(impl):
    rng = np.random.default_rng(0)
    pool = impl.pool.KVPool(num_pages=33, page_size=4, slots=4,
                            table_width=8)
    lens = [0] * 4
    for _ in range(200):
        slot = int(rng.integers(0, 4))
        if lens[slot] and rng.random() < 0.4:
            pool.release(slot)
            lens[slot] = 0
        else:
            want = min(int(lens[slot] + rng.integers(1, 9)), 32)
            if pool.can_fit(want, slot):
                pool.ensure(slot, want)
                lens[slot] = want
        pool.check()                          # every invariant, every step
    for slot in range(4):
        pool.release(slot)
    pool.check()
    assert pool.all_free()


def test_pool_sizing_helpers(impl):
    assert impl.pool.table_width_for(1024, 16, 8) == 65
    assert impl.pool.recommended_pages(8, 1024, 16, 8) == 8 * 65 + 1
    assert impl.pool.pages_for(0, 16) == 0


# ---------------------------------------------------------------------------
# the prefix trie: admission, COW, retention, eviction
# ---------------------------------------------------------------------------

def _admit(pool, slot, prompt, worst_extra=8):
    """The scheduler's admission protocol, condensed."""
    worst = len(prompt) + worst_extra
    _, shared = pool.match_prefix(prompt)
    if not pool.can_reserve(worst, shared_pages=shared):
        return None
    admit = pool.admit_prefix(slot, prompt)
    pool.reserve(slot, worst)
    pool.alloc(slot, len(prompt))
    pool.register_prefix(slot, prompt)
    return admit


def test_admit_prefix_full_match_maps_pages_read_only(impl):
    pool = impl.pool.KVPool(num_pages=32, page_size=4, slots=4,
                            table_width=8)
    p0 = list(range(10, 23))                    # 13 tokens: 3 full pages
    admit = _admit(pool, 0, p0)
    assert admit.matched_len == 0 and admit.cow is None
    assert pool.index_pages() == 3
    assert pool.match_prefix(p0) == (12, 3)
    admit = _admit(pool, 1, p0)
    assert (admit.matched_len, admit.shared_full) == (12, 3)
    assert admit.cow is None
    assert pool.owned[0][:3] == pool.owned[1][:3]
    assert pool.shared_page_refs() == 3
    for pid in pool.owned[0][:3]:
        assert pool.refcnt[pid] == 3            # 2 slots + trie
    pool.check()


def test_admit_prefix_in_page_fork_cows(impl):
    pool = impl.pool.KVPool(num_pages=32, page_size=4, slots=4,
                            table_width=8)
    p0 = list(range(10, 23))
    _admit(pool, 0, p0)
    fork = p0[:6] + [99, 98, 97, 96]            # diverges inside page 1
    admit = _admit(pool, 1, fork)
    assert admit.matched_len == 6 and admit.shared_full == 1
    src, dst = admit.cow
    assert src == pool.owned[0][1] and dst == pool.owned[1][1] and src != dst
    assert pool.owned[0][0] == pool.owned[1][0]
    assert pool.cow_copies == 1
    pool.check()


def test_release_retains_index_pages_for_future_hits(impl):
    pool = impl.pool.KVPool(num_pages=32, page_size=4, slots=2,
                            table_width=8)
    p0 = list(range(10, 22))                    # 12 tokens: 3 full pages
    _admit(pool, 0, p0)
    pool.release(0)
    pool.check()
    assert not pool.all_free()
    assert pool.index_pages() == 3
    assert pool.reclaimable() == pool.num_pages - 1
    admit = _admit(pool, 1, p0)
    assert (admit.matched_len, admit.shared_full) == (11, 2)
    pool.check()


def test_index_only_pages_evict_lru_leaf_first_under_pressure(impl):
    pool = impl.pool.KVPool(num_pages=10, page_size=4, slots=2,
                            table_width=8)
    p0 = [1] * 8 + [2] * 4                      # 3 full pages
    _admit(pool, 0, p0, worst_extra=0)
    pool.release(0)
    assert pool.index_pages() == 3
    big = [int(t) for t in range(3, 31)]
    admit = _admit(pool, 1, big, worst_extra=0)
    assert admit is not None
    assert pool.evictions > 0
    pool.check()
    pool.release(1)
    pool.check()


def test_clear_index_frees_everything(impl):
    pool = impl.pool.KVPool(num_pages=32, page_size=4, slots=2,
                            table_width=8)
    _admit(pool, 0, list(range(10, 22)))
    pool.release(0)
    assert pool.index_pages() > 0
    assert pool.clear_index() == 3 and pool.all_free()
    pool.check()


def test_prefix_cache_off_is_inert(impl):
    pool = impl.pool.KVPool(num_pages=32, page_size=4, slots=2,
                            table_width=8, prefix_cache=False)
    p0 = list(range(10, 22))
    _admit(pool, 0, p0)
    assert pool.match_prefix(p0) == (0, 0)
    assert pool.index_pages() == 0
    pool.release(0)
    assert pool.all_free()
    pool.check()


def test_can_reserve_counts_shared_pages_as_capacity(impl):
    pool = impl.pool.KVPool(num_pages=9, page_size=4, slots=2, table_width=8)
    p0 = list(range(10, 26))                    # 16 tokens: 4 pages
    _admit(pool, 0, p0, worst_extra=0)
    assert not pool.can_reserve(17)
    assert pool.match_prefix(p0)[1] == 3
    assert pool.can_reserve(17, shared_pages=3)
    pool.check()


def _prefix_churn(pool_mod, seed=1234, steps=300):
    """Randomized admit / fork / grow / retire with ``check()`` every step;
    returns the trace of every observable, step by step."""
    rng = np.random.default_rng(seed)
    ps, slots = 4, 4
    pool = pool_mod.KVPool(num_pages=24, page_size=ps, slots=slots,
                           table_width=10)
    lens = [0] * slots
    history = []
    trace = []
    admitted = deferred = 0
    for _ in range(steps):
        slot = int(rng.integers(0, slots))
        if lens[slot] == 0:
            if history and rng.random() < 0.6:   # fork a previous prompt
                base = history[int(rng.integers(0, len(history)))]
                cut = int(rng.integers(0, len(base) + 1))
                tail = rng.integers(1, 6, size=int(rng.integers(1, 12)))
                prompt = base[:cut] + [int(t) for t in tail]
            else:
                toks = rng.integers(1, 6, size=int(rng.integers(1, 24)))
                prompt = [int(t) for t in toks]
            worst = len(prompt) + int(rng.integers(1, 12))
            _, shared = pool.match_prefix(prompt)
            if not pool.can_reserve(worst, shared_pages=shared):
                deferred += 1                    # backpressure, not a crash
            else:
                admit = pool.admit_prefix(slot, prompt)
                assert admit.matched_len < len(prompt)
                pool.reserve(slot, worst)
                pool.alloc(slot, len(prompt))
                pool.register_prefix(slot, prompt)
                lens[slot] = len(prompt)
                history = (history + [prompt])[-12:]
                admitted += 1
                trace.append(("admit", slot, admit.matched_len,
                              admit.shared_full, admit.cow))
        elif rng.random() < 0.35:
            pool.release(slot)
            lens[slot] = 0
        else:
            cap = pool.reserved[slot] * ps
            want = min(lens[slot] + int(rng.integers(1, 6)), cap)
            pool.ensure(slot, want)
            lens[slot] = max(lens[slot], want)
        pool.check()                             # every invariant, every step
        trace.append((pool.tables.tolist(), list(pool.free),
                      list(pool.refcnt)))
    for slot in range(slots):
        if lens[slot]:
            pool.release(slot)
    pool.check()
    return pool, trace, admitted, deferred


def test_pool_prefix_churn_invariants(impl):
    pool, _, admitted, deferred = _prefix_churn(impl.pool)
    assert pool.allocs == pool.releases > 0
    assert pool.reclaimable() == pool.num_pages - 1
    assert admitted > 50 and deferred > 0 and pool.evictions > 0
    assert pool.prefix_hit_tokens > 0 and pool.cow_copies > 0


def test_pool_copy_replays_the_reference_step_for_step():
    for seed in (1234, 7):
        _, want, *_ = _prefix_churn(jax_kv_pool, seed=seed)
        _, got, *_ = _prefix_churn(kv_pool, seed=seed)
        assert got == want


# ---------------------------------------------------------------------------
# seize / snapshot index plumbing (kept so the reference scenarios run)
# ---------------------------------------------------------------------------

def test_pool_seize_shrinks_and_check_passes(impl):
    pool = impl.pool.KVPool(16, 4, 2, 8)
    free0 = len(pool.free)
    assert pool.seize(5) == 5 and len(pool.free) == free0 - 5
    pool.check()
    assert pool.unseize() == 5 and len(pool.free) == free0
    pool.check()


def test_pool_export_adopt_index_roundtrip(impl):
    pool = impl.pool.KVPool(32, 4, 2, 8, prefix_cache=True)
    toks = list(range(1, 13))                  # 3 full pages of 4
    pool.reserve(0, 16)
    pool.alloc(0, len(toks))
    pool.register_prefix(0, toks)
    nodes = pool.export_index()
    assert len(nodes) == 3
    pool2 = impl.pool.KVPool(32, 4, 2, 8, prefix_cache=True)
    assert pool2.adopt_index(nodes) == 3
    pool2.check()
    assert pool2.match_prefix(toks) == (11, 2)


# ---------------------------------------------------------------------------
# AdmissionQueue
# ---------------------------------------------------------------------------

def _reqs(impl, n, base=0, **kw):
    rng = np.random.default_rng(11 + base)
    return [impl.Request(rid=base + i, prompt=rng.integers(1, 64, 8).tolist(),
                         max_new_tokens=10, **kw) for i in range(n)]


def test_queue_priority_fifo_order(impl):
    q = impl.adm.AdmissionQueue()
    for i, p in enumerate([2, 0, 1, 0, 2]):
        q.push(impl.Request(rid=i, prompt=[1], max_new_tokens=1, priority=p))
    assert [r.rid for r in q.ordered()] == [1, 3, 2, 0, 4]
    assert q.head().rid == 1
    assert len(q) == 5 and q


def test_queue_reject_new_is_retryable_and_o1(impl):
    q = impl.adm.AdmissionQueue(max_queue=2)
    for r in _reqs(impl, 2):
        q.push(r)
    with pytest.raises(impl.adm.AdmissionRejected) as ei:
        q.push(_reqs(impl, 1, base=50)[0])
    rej = ei.value.rejection
    assert rej.reason == "queue_full" and rej.retryable
    assert rej.retry_after_s > 0 and rej.queue_depth == 2


def test_queue_shed_lowest_evicts_strictly_worse_only(impl):
    q = impl.adm.AdmissionQueue(max_queue=2, shed_policy="shed-lowest")
    a, b = _reqs(impl, 2, base=0, priority=2)
    q.push(a)
    q.push(b)
    urgent = _reqs(impl, 1, base=10, priority=0)[0]
    assert q.push(urgent) is b              # newest of the worst class
    assert len(q) == 2
    with pytest.raises(impl.adm.AdmissionRejected):
        q.push(_reqs(impl, 1, base=20, priority=2)[0])


def test_queue_close_refuses_nonretryable(impl):
    q = impl.adm.AdmissionQueue()
    q.close()
    with pytest.raises(impl.adm.AdmissionRejected) as ei:
        q.push(_reqs(impl, 1)[0])
    assert ei.value.rejection.reason == "draining"
    assert not ei.value.rejection.retryable


def test_queue_bypass_push_front_and_backoff(impl):
    q = impl.adm.AdmissionQueue(max_bypass=2)
    a, b, c = _reqs(impl, 3, base=30)
    for r in (a, b, c):
        q.push(r)
    assert q.bypasses(a) == 0
    assert q.note_bypass(a) == 1 and q.note_bypass(a) == 2
    assert q.bypasses(a) == 2 and q.bypasses(b) == 0
    assert q.remove(a) and not q.remove(a)
    assert q.bypasses(b) == 0                # the head changed
    q.push_front(a)                          # resume path: ahead of b
    assert [r.rid for r in q.ordered()] == [a.rid, b.rid, c.rid]
    cold = q.retry_after_s()
    q.note_service_time(2.0)
    assert q.retry_after_s() > cold
    with pytest.raises(ValueError, match="shed_policy"):
        impl.adm.AdmissionQueue(shed_policy="drop-oldest")
