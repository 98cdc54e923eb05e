"""The port's kernel registry (``repro_torch.kernels.registry``) against
the JAX package's ``repro.kernels.registry``, on the CPU.

* the families and impl names map one to one onto the reference's;
* ``parse_impl_spec`` has the reference's grammar and errors, and takes
  the reference's names too;
* the override-precedence matrix (``tests/test_registry.py:96``), the
  legacy ``REPRO_ATTN_IMPL`` mapping, env validation and the env cache;
* ``use_impl`` is thread-local;
* the heuristics: the reference's non-TPU choices for CPU tensors, the
  kernels for CUDA tensors (every prefill on the flash kernel);
* each family's impls against ``repro/kernels/ref.py``'s oracle and the
  reference registry's impls (its Pallas kernels in interpret mode) on
  the same inputs, fp32 rtol=atol=1e-5 (SSD 1e-4 / 1e-5, the reference's
  own);
* ``ServeConfig.impls`` and ``attn_impl`` on the port's engine give the
  JAX engine's greedy tokens at qwen2 ``SMOKE``, dense and paged, fp32
  and int8 pages, and the pins reach the model's calls;
* the engine's pin-validation errors are the reference's;
* a plain impl declares its work as ops (no launch).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE  # noqa: E402
from repro.core.features import default_features  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.qwen2_0_5b import SMOKE  # noqa: E402
from repro_torch.core import events  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bhsd  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ("attention", "paged_decode", "stream_triad", "jacobi7",
            "ssd_scan", "sampling")

#: static facts that drive each family's heuristic for CPU tensors
HEUR_FACTS = {
    "attention": dict(sq=256, sk=256, dh=64, backend="cpu"),
    "paged_decode": dict(backend="cpu"),
    "stream_triad": dict(backend="cpu"),
    "jacobi7": {},
    "ssd_scan": dict(backend="cpu"),
    "sampling": dict(method="greedy", backend="cpu"),
}
#: ... what they pick there / what an override flips them to
HEUR_WANT = {"attention": "full", "paged_decode": "torch_paged",
             "stream_triad": "torch_triad", "jacobi7": "wavefront",
             "ssd_scan": "torch_scan", "sampling": "torch_greedy"}
OTHER = {"attention": "cuda_flash", "paged_decode": "cuda_paged",
         "stream_triad": "cuda_triad", "jacobi7": "naive",
         "ssd_scan": "cuda_ssd", "sampling": "cuda_greedy"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("REPRO_IMPL", raising=False)
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# the registry is declarative and maps onto the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_families_and_names_map_one_to_one(family):
    assert set(registry.families()) == set(FAMILIES)
    assert family in jax_registry.families()
    theirs = jax_registry.impls(family)
    mapping = registry.REFERENCE_NAMES[family]
    assert tuple(mapping) == theirs
    # the port's own impls (no reference name) come after the reference's
    own = registry.PORT_ONLY.get(family, ())
    assert tuple(mapping[n] for n in theirs) + own == registry.impls(family)
    assert not set(own) & set(mapping.values())
    for name in theirs:
        ours = registry.get_spec(family, name)
        assert ours.name == mapping[name] and ours.family == family
        assert ours.layout and ours.doc
        module, fn = ours.oracle.rsplit(".", 1)
        assert callable(getattr(__import__(module, fromlist=[fn]), fn))
    text = registry.describe()
    assert all(n in text for n in registry.impls(family))
    # the tunable impls are the reference's tunable ones, in the port's
    # names, and describe() marks exactly those
    tunable = {mapping[n] for n in theirs
               if jax_registry.get_spec(family, n).tune is not None}
    for line in text.splitlines():
        fam, name = line.split()[:2]
        if fam == family:
            assert ("tunable" in line) == (name in tunable)
            assert (registry.get_spec(family, name).tune is not None) == \
                (name in tunable)


def test_unknown_family_and_impl_raise():
    with pytest.raises(ValueError, match="unknown kernel family"):
        registry.select("bogus")
    with pytest.raises(ValueError, match="unknown attention impl"):
        registry.get_spec("attention", "bogus")
    with pytest.raises(ValueError):
        registry.run("attention", None, None, None, impl="bogus")


@pytest.mark.parametrize("spec,want", [
    ("attention=cuda_flash, paged_decode=cuda_paged",
     {"attention": "cuda_flash", "paged_decode": "cuda_paged"}),
    ("attention=pallas_flash, paged_decode=pallas_paged",
     {"attention": "cuda_flash", "paged_decode": "cuda_paged"}),
    ("ssd_scan=jnp_scan,stream_triad=xla_triad,jacobi7=naive",
     {"ssd_scan": "torch_scan", "stream_triad": "torch_triad",
      "jacobi7": "naive"}),
    ("paged_decode=jnp_paged_q8,", {"paged_decode": "torch_paged_q8"}),
    ("", {}),
])
def test_parse_impl_spec_takes_both_spellings(spec, want):
    assert registry.parse_impl_spec(spec) == want
    theirs = jax_registry.parse_impl_spec(
        spec.replace("cuda_flash", "pallas_flash").replace(
            "cuda_paged", "pallas_paged"))
    assert {f: registry.REFERENCE_NAMES[f][n] for f, n in theirs.items()} \
        == want


@pytest.mark.parametrize("bad", ["attention", "nope=full", "attention=nope",
                                 "attention=full,paged_decode"])
def test_parse_impl_spec_errors_match_the_reference(bad):
    with pytest.raises(ValueError) as ours:
        registry.parse_impl_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jax_registry.parse_impl_spec(bad)
    # the same message up to the impl names each package lists
    first = str(theirs.value).split(";")[0].split("(")[0]
    assert str(ours.value).startswith(first)


# ---------------------------------------------------------------------------
# the override-precedence matrix, per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_override_precedence_matrix(family, monkeypatch):
    facts = HEUR_FACTS[family]
    # 1. unforced: the heuristic
    assert registry.select(family, **facts) == HEUR_WANT[family]
    # 2. REPRO_IMPL env beats heuristics
    monkeypatch.setenv("REPRO_IMPL", f"{family}={OTHER[family]}")
    assert registry.select(family, **facts) == OTHER[family]
    # 3. use_impl context beats env
    with registry.use_impl(**{family: HEUR_WANT[family]}):
        assert registry.select(family, **facts) == HEUR_WANT[family]
        # 4. inner context beats outer (and restores)
        with registry.use_impl(**{family: OTHER[family]}):
            assert registry.select(family, **facts) == OTHER[family]
        assert registry.select(family, **facts) == HEUR_WANT[family]
    assert registry.select(family, **facts) == OTHER[family]   # env again
    # 5. an env that names only OTHER families falls through to heuristics
    other_fam = "jacobi7" if family != "jacobi7" else "attention"
    monkeypatch.setenv("REPRO_IMPL", f"{other_fam}={OTHER[other_fam]}")
    assert registry.select(family, **facts) == HEUR_WANT[family]
    # 6. None values are no-ops in the context
    with registry.use_impl(**{family: None}):
        assert registry.override_for(family) is None


@pytest.mark.parametrize("family", FAMILIES)
def test_the_jax_matrix_reads_the_same_env(family, monkeypatch):
    """One REPRO_IMPL in the reference's spelling forces both packages."""
    ref_other = {v: k for k, v in registry.REFERENCE_NAMES[family].items()}
    monkeypatch.setenv("REPRO_IMPL", f"{family}={ref_other[OTHER[family]]}")
    assert registry.select(family, **HEUR_FACTS[family]) == OTHER[family]
    assert jax_registry.select(family, **HEUR_FACTS[family]) == \
        ref_other[OTHER[family]]


def test_env_repro_impl_validates_at_selection_and_is_cached(monkeypatch):
    for bad in ("attention=bogus", "bogusfam=full", "attention"):
        monkeypatch.setenv("REPRO_IMPL", bad)
        with pytest.raises(ValueError):
            registry.select("attention", sq=8, sk=8, dh=8, backend="cpu")
    monkeypatch.setenv("REPRO_IMPL", "attention=torch_flash")
    before = registry._env_impls.cache_info().hits
    for _ in range(3):
        assert registry.select("attention", sq=8, sk=8, dh=8,
                               backend="cpu") == "torch_flash"
    assert registry._env_impls.cache_info().hits >= before + 2
    monkeypatch.setenv("REPRO_IMPL", "attention=full")   # a new value
    assert registry.select("attention", sq=8, sk=8, dh=8,
                           backend="cuda") == "full"


def test_env_snapshot_reads_the_environment_once(monkeypatch):
    monkeypatch.setenv("REPRO_IMPL", "ssd_scan=torch_scan")
    with registry.env_snapshot():
        monkeypatch.setenv("REPRO_IMPL", "ssd_scan=cuda_ssd")
        assert registry.override_for("ssd_scan") == "torch_scan"
        with registry.use_impl(ssd_scan="cuda_ssd"):   # a pin still wins
            assert registry.override_for("ssd_scan") == "cuda_ssd"
        seen = {}
        th = threading.Thread(target=lambda: seen.update(
            worker=registry.override_for("ssd_scan")))
        th.start()
        th.join()
        assert seen["worker"] == "cuda_ssd"    # thread-local snapshot
    assert registry.override_for("ssd_scan") == "cuda_ssd"
    monkeypatch.setenv("REPRO_ATTN_IMPL", "bogus")
    with registry.env_snapshot():
        with pytest.raises(ValueError, match="REPRO_ATTN_IMPL"):
            registry.select("attention", sq=8, sk=8, dh=8)


def test_use_impl_spec_string_form():
    with registry.use_impl("attention=torch_flash,ssd_scan=pallas_ssd"):
        assert registry.override_for("attention") == "torch_flash"
        assert registry.override_for("ssd_scan") == "cuda_ssd"
        assert registry.override_for("jacobi7") is None
    with pytest.raises(ValueError, match="unknown ssd_scan impl"):
        with registry.use_impl(ssd_scan="bogus"):
            pass


def test_use_impl_is_thread_local():
    seen = {}

    def worker():
        seen["worker"] = registry.override_for("attention")

    with registry.use_impl(attention="torch_flash"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        assert registry.override_for("attention") == "torch_flash"
    assert seen["worker"] is None      # the context never leaked threads
    assert registry.override_for("attention") is None


# ---------------------------------------------------------------------------
# legacy names
# ---------------------------------------------------------------------------

def test_legacy_map_mirrors_the_reference():
    for name, theirs in jax_registry.LEGACY_ATTN_MAP.items():
        ours = registry.legacy_mapping(name)
        assert ours == {f: registry.REFERENCE_NAMES[f][n]
                        for f, n in theirs.items()}, name
    assert registry.legacy_mapping("bogus") is None
    assert registry.legacy_mapping("cuda_flash") == \
        registry.legacy_mapping("pallas_flash")


def test_legacy_paged_decode_pin_is_decode_side_only(monkeypatch):
    monkeypatch.setenv("REPRO_ATTN_IMPL", "paged_decode")
    assert registry.select("paged_decode", backend="cpu") == "cuda_paged"
    assert registry.select("attention", **HEUR_FACTS["attention"]) == "full"


def test_legacy_env_loses_to_repro_impl(monkeypatch):
    monkeypatch.setenv("REPRO_ATTN_IMPL", "full")
    assert registry.select("attention", **HEUR_FACTS["attention"]) == "full"
    # the legacy name maps the decode side too (full -> the plain version)
    assert registry.select("paged_decode", backend="cuda") == "torch_paged"
    monkeypatch.setenv("REPRO_IMPL", "attention=torch_flash")
    assert registry.select("attention", **HEUR_FACTS["attention"]) \
        == "torch_flash"
    # families REPRO_IMPL does not name still take the legacy mapping
    assert registry.select("paged_decode", backend="cuda") == "torch_paged"
    # legacy names never touch the other families
    assert registry.select("stream_triad", backend="cuda") == "cuda_triad"


def test_legacy_env_validates(monkeypatch):
    monkeypatch.setenv("REPRO_ATTN_IMPL", "bogus")
    with pytest.raises(ValueError, match="REPRO_ATTN_IMPL"):
        registry.select("attention", sq=8, sk=8, dh=8)


# ---------------------------------------------------------------------------
# the heuristics: the device of the call's tensors decides
# ---------------------------------------------------------------------------

def test_cuda_heuristics_launch_the_kernels():
    cuda = dict(backend="cuda")
    for sq in (1, 7, 64, 5000):
        assert registry.select("attention", sq=sq, sk=sq, dh=64,
                               flash_min_seq=2048, **cuda) == "cuda_flash"
    # a head dim the kernel lacks still selects it: its wrapper raises on
    # the card, and only a pin runs the plain version there
    for dh in (48, 100):
        assert registry.select("attention", sq=64, sk=64, dh=dh,
                               **cuda) == "cuda_flash"
    # ... and the head dims it holds, stablelm-3b's 80 among them
    from repro_torch.kernels import flash_attention, paged_decode
    assert 80 in flash_attention.SUPPORTED_HEAD_DIMS
    assert 80 in paged_decode.SUPPORTED_HEAD_DIMS
    assert 48 not in flash_attention.SUPPORTED_HEAD_DIMS
    assert registry.select("attention", sq=512, sk=512, dh=80,
                           **cuda) == "cuda_flash"
    assert registry.select("paged_decode", **cuda) == "cuda_paged"
    assert registry.select("paged_decode", quantized=True,
                           **cuda) == "cuda_paged_q8"
    assert registry.select("stream_triad", **cuda) == "cuda_triad"
    assert registry.select("ssd_scan", **cuda) == "cuda_ssd"
    assert registry.select("jacobi7", **cuda) == "wavefront"
    # no backend fact: the port's default device
    assert registry.select("ssd_scan") == "cuda_ssd"


def test_cpu_heuristics_mirror_the_reference():
    for sq, thr in ((16, 2048), (2048, 2048), (300, 256)):
        ours = registry.select("attention", sq=sq, sk=sq, dh=16,
                               flash_min_seq=thr, backend="cpu")
        theirs = jax_registry.select("attention", sq=sq, sk=sq, dh=16,
                                     flash_min_seq=thr, backend="cpu")
        assert ours == registry.REFERENCE_NAMES["attention"][theirs]
    for quantized in (False, True):
        theirs = jax_registry.select("paged_decode", quantized=quantized,
                                     backend="cpu")
        assert registry.select("paged_decode", quantized=quantized,
                               backend="cpu") == \
            registry.REFERENCE_NAMES["paged_decode"][theirs]


def test_run_self_selects_from_the_tensors_device():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    want = np.asarray(ref.flash_attention(q, k, v, causal=True))
    before = flash_attention_bhsd.launches
    with events.collect() as ev:
        got = registry.run("attention", t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert flash_attention_bhsd.launches == before   # the CPU's "full"
    assert ev["LAUNCHES"] == 0 and ev["FLOPS_TOTAL"] > 0


# ---------------------------------------------------------------------------
# each family's impls against the oracle and the reference's registry
# ---------------------------------------------------------------------------

def _attention_inputs(seed, b=3, sq=24, sk=24, h=4, kvh=2, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    kv_len = np.array([sk, 17, 5][:b], np.int32)
    return q, k, v, kv_len


@pytest.mark.parametrize("case", [
    dict(q_offset=0, causal=True, ragged=True),
    dict(q_offset=0, causal=False, ragged=True),
    dict(q_offset=0, causal=True, ragged=False, chunk_threshold=8,
         chunk_size=8),
])
def test_attention_impls_match_oracle_and_reference(case):
    q, k, v, kv_len = _attention_inputs(0)
    kw = dict(q_offset=case["q_offset"], causal=case["causal"])
    lens = kv_len if case["ragged"] else None
    want = np.asarray(ref.flash_attention(q, k, v, kv_valid=lens, **kw))
    extra = {n: case[n] for n in ("chunk_threshold", "chunk_size")
             if n in case}
    for name in jax_registry.impls("attention"):
        theirs = np.asarray(jax_registry.run(
            "attention", jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            impl=name, kv_len=None if lens is None else jnp.asarray(lens),
            interpret=True, **kw, **extra))
        ours = registry.run("attention", t(q), t(k), t(v), impl=name,
                            kv_len=None if lens is None else t(lens),
                            **kw, **extra).numpy()
        np.testing.assert_allclose(ours, want, **TOL, err_msg=name)
        np.testing.assert_allclose(ours, theirs, **TOL, err_msg=name)


def test_attention_impls_agree_at_a_query_offset():
    q, k, v, _ = _attention_inputs(1, sq=6, sk=24)
    want = np.asarray(ref.flash_attention(q, k, v, q_offset=18))
    for name in registry.impls("attention"):
        if name in registry.PORT_ONLY["attention"]:
            # the training kernels take self-attention from position 0
            with pytest.raises(ValueError, match="no q_offset"):
                registry.run("attention", t(q), t(k), t(v), impl=name,
                             q_offset=18)
            continue
        got = registry.run("attention", t(q), t(k), t(v), impl=name,
                           q_offset=18).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def _paged_inputs(seed, quantized, b=3, kvh=2, g=3, dh=16, ps=8, np_w=5):
    rng = np.random.default_rng(seed)
    lens = np.array([0, 9, 33][:b], np.int32)
    p = b * np_w + 1
    table = (1 + np.arange(b * np_w, dtype=np.int32)).reshape(b, np_w)
    q = rng.standard_normal((b, 1, kvh * g, dh)).astype(np.float32)
    kn = rng.standard_normal((b, 1, kvh, dh)).astype(np.float32)
    vn = rng.standard_normal((b, 1, kvh, dh)).astype(np.float32)
    if quantized:
        kp = rng.integers(-127, 128, (p, ps, kvh, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (p, ps, kvh, dh)).astype(np.int8)
        sc = dict(k_scale=rng.uniform(0.001, 0.02, (p, ps)).astype(
            np.float32), v_scale=rng.uniform(0.001, 0.02, (p, ps)).astype(
            np.float32))
    else:
        kp = rng.standard_normal((p, ps, kvh, dh)).astype(np.float32)
        vp = rng.standard_normal((p, ps, kvh, dh)).astype(np.float32)
        sc = {}
    return q, kp, vp, table, lens, kn, vn, sc


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_impls_match_oracle_and_reference(quantized):
    q, kp, vp, table, lens, kn, vn, sc = _paged_inputs(2, quantized)
    b, _, h, dh = q.shape
    kvh = kp.shape[2]
    oracle = ref.paged_decode_q8 if quantized else ref.paged_decode
    want = np.asarray(oracle(q, kp, vp, table, lens, kn, vn, **sc))
    names = [n for n in jax_registry.impls("paged_decode")
             if n.endswith("_q8") == quantized]
    assert len(names) == 2
    for name in names:
        theirs = np.asarray(jax_registry.run(
            "paged_decode", *(jnp.asarray(a) for a in
                              (q, kp, vp, table, lens, kn, vn)),
            impl=name, interpret=True,
            **{k_: jnp.asarray(v_) for k_, v_ in sc.items()}))
        ours = registry.run(
            "paged_decode", t(q.reshape(b, kvh, h // kvh, dh)), t(kp), t(vp),
            t(table), t(lens), t(kn[:, 0]), t(vn[:, 0]), impl=name,
            **{k_: t(v_) for k_, v_ in sc.items()}).numpy()
        ours = ours.reshape(b, 1, h, dh)
        np.testing.assert_allclose(ours, want, **TOL, err_msg=name)
        np.testing.assert_allclose(ours, theirs, **TOL, err_msg=name)
        with pytest.raises(ValueError, match="unknown paged_decode impl"):
            registry.get_spec("paged_decode", name + "_x")


def test_stream_triad_impls_match_oracle_and_reference():
    rng = np.random.default_rng(4)
    b = rng.standard_normal(128 * 4).astype(np.float32)
    c = rng.standard_normal(128 * 4).astype(np.float32)
    want = np.asarray(ref.stream_triad(None, b, c, 2.5))
    for name in jax_registry.impls("stream_triad"):
        theirs = np.asarray(jax_registry.run(
            "stream_triad", jnp.asarray(b), jnp.asarray(c), impl=name,
            s=2.5, interpret=True))
        ours = registry.run("stream_triad", t(b), t(c), impl=name,
                            s=2.5).numpy()
        np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    got = registry.run("stream_triad", t(b), t(c), s=2.5)   # self-selects
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_jacobi7_impls_match_oracle_and_reference():
    x = np.random.default_rng(5).standard_normal((12, 10, 10)).astype(
        np.float32)
    want = np.asarray(ref.jacobi7_valid(x, sweeps=2))
    for name in jax_registry.impls("jacobi7"):
        theirs = np.asarray(jax_registry.run(
            "jacobi7", jnp.asarray(x), impl=name, sweeps=2, interpret=True))
        with events.collect() as ev:
            ours = registry.run("jacobi7", t(x), impl=name,
                                sweeps=2).numpy()
        np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
        assert ev["LAUNCHES"] == (1 if name == "wavefront" else 2)


@pytest.mark.parametrize("carried", [False, True])
def test_ssd_scan_impls_match_oracle_and_reference(carried):
    rng = np.random.default_rng(6)
    b, s, h, dk, dv = 1, 32, 2, 8, 8

    def rn(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    q, k, v = rn(b, s, h, dk), rn(b, s, h, dk), rn(b, s, h, dv)
    lf = -np.abs(rn(b, s, h, scale=0.1))
    li = -np.abs(rn(b, s, h, scale=0.1))
    init = (rn(b, h, dk, dv), np.abs(rn(b, h, dk))) if carried else None
    want_y, (want_c, want_n) = ref.ssd_scan(
        q, k, v, lf, li,
        initial_state=None if init is None else tuple(map(jnp.asarray, init)))
    tol = dict(rtol=1e-4, atol=1e-5)
    for name in jax_registry.impls("ssd_scan"):
        ours_y, (ours_c, ours_n) = registry.run(
            "ssd_scan", t(q), t(k), t(v), t(lf), t(li), impl=name, chunk=16,
            initial_state=None if init is None else tuple(map(t, init)))
        np.testing.assert_allclose(ours_y.numpy(), want_y, **tol)
        np.testing.assert_allclose(ours_c.numpy(), want_c, **tol)
        np.testing.assert_allclose(ours_n.numpy(), want_n, **tol)
        if not carried:      # the reference's runners carry no state
            theirs_y, (theirs_c, _) = jax_registry.run(
                "ssd_scan", *(jnp.asarray(a) for a in (q, k, v, lf, li)),
                impl=name, chunk=16, interpret=True)
            np.testing.assert_allclose(ours_y.numpy(), theirs_y, **tol)
            np.testing.assert_allclose(ours_c.numpy(), theirs_c, **tol)


def _family_args(family, quantized=False):
    """(args, kwargs) of one small call of ``family``, CPU tensors."""
    rng = np.random.default_rng(7)
    if family == "attention":
        q, k, v, kv_len = _attention_inputs(7)
        return (t(q), t(k), t(v)), dict(kv_len=t(kv_len))
    if family == "paged_decode":
        q, kp, vp, table, lens, kn, vn, sc = _paged_inputs(7, quantized)
        b, _, h, dh = q.shape
        kvh = kp.shape[2]
        return ((t(q.reshape(b, kvh, h // kvh, dh)), t(kp), t(vp), t(table),
                 t(lens), t(kn[:, 0]), t(vn[:, 0])),
                {k_: t(v_) for k_, v_ in sc.items()})
    if family == "stream_triad":
        return (t(rng.standard_normal(256).astype(np.float32)),
                t(rng.standard_normal(256).astype(np.float32))), {}
    b, s, h, dk = 1, 20, 2, 4
    x = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    lf = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32)
    return (t(x), t(x), t(x), t(lf), t(lf * 0)), dict(chunk=8)


@pytest.mark.parametrize("family,plain,kernel", [
    ("attention", "torch_flash", "cuda_flash"),
    ("attention", "full", "cuda_flash"),
    ("paged_decode", "torch_paged", "cuda_paged"),
    ("paged_decode", "torch_paged_q8", "cuda_paged_q8"),
    ("stream_triad", "torch_triad", "cuda_triad"),
    ("ssd_scan", "torch_scan", "cuda_ssd"),
])
def test_plain_impls_declare_the_kernels_work_with_no_launch(family, plain,
                                                             kernel):
    args, kw = _family_args(family, quantized=plain.endswith("_q8"))
    counts = {}
    for impl in (plain, kernel):
        with events.collect() as ev:
            registry.run(family, *args, impl=impl, **kw)
        counts[impl] = dict(ev.counts)
    assert counts[kernel].pop("LAUNCHES") == 1   # the wrapper's plain twin
    assert counts[plain].pop("LAUNCHES") == 0
    assert counts[plain] == counts[kernel]
    assert counts[plain]["BYTES_ACCESSED"] > 0


# ---------------------------------------------------------------------------
# the engine: ServeConfig.impls / attn_impl against the JAX engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (10, 3, 1, 6)
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    jlm = JaxLM(JAX_SMOKE, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, SMOKE))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SMOKE.vocab, n).tolist() for n in PROMPT_LENS]
    return jlm, jax.tree.map(jnp.asarray, jparams), lm, prompts


#: (page_size, kv_dtype, the JAX engine's pins) — the port takes the same
#: spelling and its own
ENGINE_CASES = [
    (0, None, dict(impls={"attention": "jnp_flash"})),
    (0, None, dict(impls={"attention": "pallas_flash"})),
    (0, None, dict(attn_impl="full")),
    (4, None, dict(impls={"attention": "full",
                          "paged_decode": "pallas_paged"})),
    (4, None, dict(impls={"paged_decode": "jnp_paged"})),
    (4, None, dict(attn_impl="jnp_flash")),
    (4, "int8", dict(impls={"paged_decode": "pallas_paged_q8"})),
    (4, "int8", dict(impls={"attention": "jnp_flash",
                            "paged_decode": "jnp_paged_q8"})),
]


def _port_spelling(kw):
    if "impls" in kw:
        return dict(impls={f: registry.REFERENCE_NAMES[f][n]
                           for f, n in kw["impls"].items()})
    return dict(attn_impl=registry.REFERENCE_NAMES["attention"].get(
        kw["attn_impl"], kw["attn_impl"]))


@pytest.mark.parametrize("page_size,kv_dtype,pins", ENGINE_CASES)
def test_engine_pins_give_the_jax_engines_tokens(models, page_size,
                                                 kv_dtype, pins):
    jlm, jparams, lm, prompts = models
    want = JaxEngine(jlm, jparams, JaxServeConfig(
        max_seq=64, page_size=page_size, kv_dtype=kv_dtype,
        **pins)).generate(prompts, MAX_NEW)
    for kw in (pins, _port_spelling(pins)):
        eng = Engine(lm, ServeConfig(max_seq=64, page_size=page_size,
                                     kv_dtype=kv_dtype, **kw), device="cpu")
        assert eng.generate(prompts, MAX_NEW) == want, kw
    assert len({tuple(x) for x in want}) > 1


def test_engine_pins_reach_every_call_and_leave_nothing_behind(models,
                                                               monkeypatch):
    _, _, lm, prompts = models
    seen = []
    real = registry.select

    def spy(family, **facts):
        out = real(family, **facts)
        seen.append((family, out))
        return out

    monkeypatch.setattr(registry, "select", spy)
    eng = Engine(lm, ServeConfig(max_seq=64, page_size=4, impls={
        "attention": "torch_flash", "paged_decode": "torch_paged"}),
        device="cpu")
    eng.generate(prompts, 3)
    # sampling goes through the registry too (unpinned: the CPU's plain
    # impl), as the JAX engine samples
    assert set(seen) == {("attention", "torch_flash"),
                         ("paged_decode", "torch_paged"),
                         ("sampling", "torch_greedy")}
    seen.clear()
    from repro_torch.serve.engine import BatchScheduler, Request
    sched = BatchScheduler(eng)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    sched.run()
    # sampling goes through the registry too (unpinned: the CPU's plain
    # impl), as the JAX engine samples
    assert set(seen) == {("attention", "torch_flash"),
                         ("paged_decode", "torch_paged"),
                         ("sampling", "torch_greedy")}
    assert registry.override_for("attention") is None
    # REPRO_IMPL loses to the engine's pin, as in the JAX engine
    monkeypatch.setenv("REPRO_IMPL", "attention=full")
    seen.clear()
    eng.generate(prompts, 2)
    assert ("attention", "torch_flash") in seen
    assert ("attention", "full") not in seen


@pytest.mark.parametrize("kw,match", [
    (dict(impls={"attention": "bogus"}), "unknown attention impl"),
    (dict(impls={"bogus": "full"}), "unknown kernel family"),
    (dict(attn_impl="bogus"), "unknown attention impl"),
    (dict(impls={"paged_decode": "pallas_paged"}), "page_size"),
    (dict(attn_impl="paged_decode"), "page_size"),
    (dict(page_size=4, kv_dtype="int8",
          impls={"paged_decode": "pallas_paged"}),
     "cannot read kv_dtype='int8' pages"),
    (dict(page_size=4, impls={"paged_decode": "jnp_paged_q8"}),
     "cannot read kv_dtype='model-dtype' pages"),
    (dict(page_size=4, kv_dtype="int8", attn_impl="pallas_flash"),
     "cannot read kv_dtype='int8' pages"),
])
def test_engine_pin_errors_match_the_reference(models, kw, match):
    jlm, jparams, lm, _ = models
    with pytest.raises(ValueError, match=match) as ours:
        Engine(lm, ServeConfig(max_seq=64, **kw), device="cpu")
    try:
        JaxEngine(jlm, jparams, JaxServeConfig(max_seq=64, **kw)
                  ).generate([[1, 2]], 1)
    except ValueError as theirs:
        # the same error up to the impl names each package lists
        head = str(theirs).split("pin one of")[0].split("choose from")[0]
        for fam in ("attention", "paged_decode"):
            for name, port in registry.REFERENCE_NAMES[fam].items():
                head = head.replace(f"'{name}'", f"'{port}'")
        assert str(ours.value).startswith(head)
    else:
        pytest.fail(f"the JAX engine accepted {kw}")
