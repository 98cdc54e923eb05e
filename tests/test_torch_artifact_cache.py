"""The port's artifact cache (``repro_torch.core.artifact_cache``) against
the JAX package's ``repro.core.artifact_cache``, on the CPU.

* ``canonical_digest`` gives the reference's digest for the same key
  material; both packages read the same ``$REPRO_CACHE_DIR`` and default
  root;
* an entry is the reference's bytes at the reference's path
  (``v1/<dd>/<digest>.json``), and each package reads the other's file;
* the port stores no ``.hlo.zlib`` companion;
* corrupt entries are quarantined as ``*.corrupt`` and read as misses,
  with the reference's stats and rendering; ``entries`` / ``clear``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core import artifact_cache as jax_cache  # noqa: E402
from repro_torch.core import artifact_cache as cache  # noqa: E402

torch.set_num_threads(1)

MATERIALS = [
    {"kind": "measure", "fn": "f:abc", "args": {"leaves": [1, 2]}},
    {"b": 2, "a": [1.5, None, "x"], "nested": {"z": 1, "y": [True]}},
    {"kind": "tune-choice", "family": "attention",
     "key": "b2h4kvh2sq128sk192dh32-float32-causal-cuda",
     "toolchain": {"torch": "2.11.0", "repro_src": "0123"}},
    {"obj": object.__name__, "tuple": (1, 2), "float": 1e-300},
]


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "root"))


@pytest.mark.parametrize("material", MATERIALS)
def test_canonical_digest_is_the_references(material):
    assert cache.canonical_digest(material) == \
        jax_cache.canonical_digest(material)
    # key order never matters
    flipped = dict(reversed(list(material.items())))
    assert cache.canonical_digest(flipped) == cache.canonical_digest(material)


def test_both_packages_read_the_same_root(tmp_path, monkeypatch):
    assert cache.SCHEMA_VERSION == jax_cache.SCHEMA_VERSION
    assert cache.default_cache_dir() == jax_cache.default_cache_dir() \
        == str(tmp_path / "root")
    monkeypatch.delenv("REPRO_CACHE_DIR")
    assert cache.default_cache_dir() == jax_cache.default_cache_dir()
    assert cache.ArtifactCache().root == jax_cache.ArtifactCache().root


def test_entry_layout_and_bytes_are_the_references(tmp_path):
    ours = cache.ArtifactCache(str(tmp_path / "ours"))
    theirs = jax_cache.ArtifactCache(str(tmp_path / "theirs"))
    digest = cache.canonical_digest(MATERIALS[0])
    entry = {"kind": "measure", "events": {"counts": {"LAUNCHES": 1.0}},
             "device_s": 1.25e-5, "key": MATERIALS[0]}
    ours.put(digest, entry)
    theirs.put(digest, entry)
    rel = os.path.join("v1", digest[:2], f"{digest}.json")
    a = (tmp_path / "ours" / rel).read_bytes()
    b = (tmp_path / "theirs" / rel).read_bytes()
    assert a == b
    assert json.loads(a)["schema"] == cache.SCHEMA_VERSION
    # each package reads the other's file
    assert theirs.get(digest) == ours.get(digest) == dict(
        entry, schema=cache.SCHEMA_VERSION)
    # no HLO companion on the port's side
    assert os.listdir(tmp_path / "ours" / "v1" / digest[:2]) == \
        [f"{digest}.json"]
    assert not hasattr(ours, "get_hlo")
    assert list(ours.entries()) == [digest] and len(ours) == 1


@pytest.mark.parametrize("garbage", [b"{not json", b"[1, 2]",
                                     b'{"schema": 999}', b""])
def test_corrupt_entries_are_quarantined_as_the_references(tmp_path,
                                                           garbage):
    stats = []
    for mod, name in ((cache, "ours"), (jax_cache, "theirs")):
        c = mod.ArtifactCache(str(tmp_path / name))
        digest = mod.canonical_digest({"k": 1})
        c.put(digest, {"v": 1})
        path = os.path.join(c.tree, digest[:2], f"{digest}.json")
        with open(path, "wb") as f:
            f.write(garbage)
        assert c.get(digest) is None                 # a miss, not a crash
        assert os.path.exists(path + ".corrupt")
        assert not os.path.exists(path)
        assert c.get(digest) is None                 # still a miss
        c.put(digest, {"v": 2})                      # healed
        assert c.get(digest)["v"] == 2
        stats.append((c.stats.hits, c.stats.misses, c.stats.stores,
                      c.stats.corrupt_evictions, c.stats.quarantined,
                      c.stats.render()))
    assert stats[0] == stats[1]
    assert "1 corrupt evicted" in stats[0][-1]


def test_disabled_cache_and_clear(tmp_path):
    off = cache.ArtifactCache(str(tmp_path / "off"), enabled=False)
    off.put("ab" * 32, {"v": 1})
    assert off.get("ab" * 32) is None and len(off) == 0
    assert off.stats.render() == jax_cache.CacheStats().render()
    c = cache.ArtifactCache(str(tmp_path / "on"))
    for i in range(3):
        c.put(cache.canonical_digest({"i": i}), {"i": i})
    assert len(c) == 3
    assert c.clear() == 3 and len(c) == 0
    assert c.quarantine("cd" * 32) is False
