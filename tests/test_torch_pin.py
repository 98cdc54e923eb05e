"""likwid-pin on the port (``repro_torch.core.pin``, a copy of
``repro/core/pin.py``) against the JAX package, on the CPU.

``parse_pinlist`` gives the same ids and the same errors (hypothesis
cases as in ``tests/test_pin.py``); every strategy with seeded skip masks
gives the reference's order over both production pods; ``describe`` gives
the same string; the pin CLI prints the reference's hop table.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # hypothesis is an optional test dependency (pip install repro[test])
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover — property tests skip without it
    _SKIP = pytest.mark.skip(reason="hypothesis not installed")

    def given(*_a, **_k):
        return lambda fn: _SKIP(fn)

    def settings(*_a, **_k):
        return lambda fn: fn

    class _NullStrategies:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _NullStrategies()

from repro.core import pin as jax_pin  # noqa: E402
from repro.core import topology as jax_topo  # noqa: E402
from repro.launch import pin as jax_pin_cli  # noqa: E402
from repro_torch.core import pin  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.launch import pin as pin_cli  # noqa: E402

torch.set_num_threads(1)

TOPOS = {
    "1pod": (topology.synthesize(topology.PRODUCTION_SINGLE_POD),
             jax_topo.synthesize(jax_topo.PRODUCTION_SINGLE_POD)),
    "2pod": (topology.synthesize(topology.PRODUCTION_MULTI_POD),
             jax_topo.synthesize(jax_topo.PRODUCTION_MULTI_POD)),
}


def _both(fn, *args):
    """(result or the error's type and message) of ``fn`` in each package."""
    out = []
    for mod in (pin, jax_pin):
        try:
            out.append(("ok", getattr(mod, fn)(*args)))
        except ValueError as e:
            out.append(("err", str(e)))
    return out


@pytest.mark.parametrize("text", ["0-3,8,12-13", "5", " 1 , 3-4 ,", "",
                                  "0-3,2", "8,8", "5-3", "a-b", "1-2-3"])
def test_parse_pinlist_matches_the_reference(text):
    ours, theirs = _both("parse_pinlist", text)
    assert ours == theirs


@given(st.lists(st.integers(0, 511), min_size=1, max_size=64, unique=True))
@settings(max_examples=50, deadline=None)
def test_pinlist_roundtrip_matches_the_reference(ids):
    s = ",".join(str(i) for i in ids)
    assert pin.parse_pinlist(s) == jax_pin.parse_pinlist(s) == ids


@given(st.lists(st.integers(0, 40), min_size=1, max_size=12))
@settings(max_examples=50, deadline=None)
def test_pinlist_errors_match_the_reference(ids):
    s = ",".join(f"{i}-{i + 2}" for i in ids)
    ours, theirs = _both("parse_pinlist", s)
    assert ours == theirs


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ["compact", "scatter", "ring",
                                  "0-63,128-191", "255-200,7"])
@pytest.mark.parametrize("topo", list(TOPOS))
def test_every_strategy_gives_the_reference_order(topo, name, seed):
    ours_t, theirs_t = TOPOS[topo]
    rng = np.random.default_rng(seed)
    skip = sorted(rng.choice(ours_t.total_chips, size=seed * 3,
                             replace=False).tolist())
    try:
        theirs = jax_pin.get_strategy(name)(theirs_t, skip=skip)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            pin.get_strategy(name)(ours_t, skip=skip)
        return
    ours = pin.get_strategy(name)(ours_t, skip=skip)
    assert ours.device_ids == theirs.device_ids
    assert (ours.strategy, ours.skipped) == (theirs.strategy, theirs.skipped)
    assert ours.describe() == theirs.describe()


def test_unknown_strategy_and_missing_devices_raise_like_the_reference():
    ours_t, theirs_t = TOPOS["1pod"]
    for bad in ("bogus", "spiral"):
        with pytest.raises(ValueError) as ours:
            pin.get_strategy(bad)
        with pytest.raises(ValueError) as theirs:
            jax_pin.get_strategy(bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=r"not in topology: \[300\]"):
        pin.get_strategy("0-3,300")(ours_t)
    assert sorted(pin.STRATEGIES) == sorted(jax_pin.STRATEGIES)


def test_a_probed_card_pins_to_itself():
    one = topology.probe("cpu")
    for name in pin.STRATEGIES:
        assert pin.get_strategy(name)(one).device_ids == (0,)
    assert pin.Compact()(one, skip=[0]).device_ids == ()


@pytest.mark.parametrize("argv", [["--compare"], ["--compare", "--multi-pod"],
                                  ["-c", "ring", "--skip", "5,17"],
                                  ["-c", "0-255", "--skip", "3"]])
def test_pin_cli_prints_the_reference_table(argv, capsys):
    assert pin_cli.main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_pin_cli.main(argv) == 0
    assert ours == capsys.readouterr().out
