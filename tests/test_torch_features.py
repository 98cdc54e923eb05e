"""likwid-features on the port (``repro_torch.core.features``) against the
JAX package's ``repro.core.features``, on the CPU.

The same fields, defaults and ``validate`` errors; ``from_env`` under the
same ``REPRO_FEATURE_*`` environment; ``render_state`` holds the same
feature rows (name and state; the meaning column is CUDA's); the PyTorch
settings the state implies; the features CLI.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import features as jax_features  # noqa: E402
from repro_torch.core import features  # noqa: E402
from repro_torch.launch import features as features_cli  # noqa: E402

torch.set_num_threads(1)

XLA_ONLY = ("scan_layers", "scan_unroll", "async_collectives",
            "collective_matmul", "prefetch_to_vmem")


def test_fields_and_defaults_match_the_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(
        features.FeatureSet)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(
        jax_features.FeatureSet)]
    assert ours == theirs
    assert dataclasses.asdict(features.default_features()) == \
        dataclasses.asdict(jax_features.default_features())
    assert set(features.FEATURE_DOC) == set(jax_features.FEATURE_DOC)
    for name in XLA_ONLY:
        assert features.FEATURE_DOC[name].startswith("XLA only")
    assert "set_float32_matmul_precision" in \
        features.FEATURE_DOC["matmul_precision"]


@pytest.mark.parametrize("kw", [
    dict(remat_policy="bogus"), dict(matmul_precision="fp8"),
    dict(grad_compression="topk"), dict(scan_unroll=0),
    dict(remat_policy="full", scan_unroll=4), dict(matmul_precision="high"),
])
def test_validate_matches_the_reference(kw):
    outcome = []
    for mod in (features, jax_features):
        try:
            outcome.append(("ok", dataclasses.asdict(
                mod.default_features().with_(**kw))))
        except ValueError as e:
            outcome.append(("err", str(e)))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_FEATURE_REMAT_POLICY": "full", "REPRO_FEATURE_SCAN_UNROLL": "3",
     "REPRO_FEATURE_ASYNC_COLLECTIVES": "off"},
    {"REPRO_FEATURE_DECODE_INPLACE_CACHE": "yes",
     "REPRO_FEATURE_COMPUTE_DTYPE": "float32",
     "REPRO_FEATURE_MATMUL_PRECISION": "highest"},
])
def test_from_env_matches_the_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(features.from_env()) == \
        dataclasses.asdict(jax_features.from_env())


def test_from_env_validates_like_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_FEATURE_REMAT_POLICY", "everything")
    with pytest.raises(ValueError) as ours:
        features.from_env()
    with pytest.raises(ValueError) as theirs:
        jax_features.from_env()
    assert str(ours.value) == str(theirs.value)


def test_render_state_holds_the_reference_rows():
    fs = features.default_features().with_(remat_policy="none",
                                           scan_unroll=2)
    jfs = jax_features.default_features().with_(remat_policy="none",
                                                scan_unroll=2)

    def rows(text):
        return [tuple(line.split()[:2]) for line in text.splitlines()[2:]]

    ours, theirs = features.render_state(fs), jax_features.render_state(jfs)
    assert ours.splitlines()[:2] == theirs.splitlines()[:2]
    assert rows(ours) == rows(theirs)
    assert ("scan_layers", "ON") in rows(ours)


@pytest.mark.parametrize("precision,want", [("default", "medium"),
                                            ("high", "high"),
                                            ("highest", "highest")])
def test_torch_settings_follow_the_state(precision, want):
    fs = features.default_features().with_(matmul_precision=precision,
                                           compute_dtype="float32")
    before = torch.get_float32_matmul_precision()
    got = features.torch_settings_for(fs)
    assert got == [f"torch.set_float32_matmul_precision('{want}')",
                   "compute dtype torch.float32"]
    assert want in ("medium", "high", "highest")   # torch's vocabulary
    # reported, not applied
    assert torch.get_float32_matmul_precision() == before


def test_features_cli_sets_exports_and_reports(capsys, monkeypatch):
    assert features_cli.main(["--set", "remat_policy=full", "scan_unroll=2",
                              "donate_state=off", "--export",
                              "--torch-settings"]) == 0
    out = capsys.readouterr().out
    assert "export REPRO_FEATURE_REMAT_POLICY=full" in out
    assert "export REPRO_FEATURE_SCAN_UNROLL=2" in out
    assert "torch.set_float32_matmul_precision('medium')" in out
    assert "remat_policy         full" in out
    # the exported lines drive from_env in a child
    monkeypatch.setenv("REPRO_FEATURE_REMAT_POLICY", "full")
    assert features.from_env().remat_policy == "full"
    for bad in (["--set", "bogus=1"], ["--set", "novalue"],
                ["--set", "remat_policy=bogus"]):
        with pytest.raises((SystemExit, ValueError)):
            features_cli.main(bad)
