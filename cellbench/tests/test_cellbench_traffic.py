"""The traffic generator: a pure function of its seed, lengths in the
stated ranges, and the same sizes for every seed."""

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from cellbench import traffic as T

MIXES = Path(__file__).resolve().parents[1] / "traffic"
SERVE = sorted(p.stem for p in MIXES.glob("serve.*.json"))
TRAIN = sorted(p.stem for p in MIXES.glob("train.*.json"))


def _asks(spec, seed, sessions=40, vocab=151936):
    s = T.Sessions(spec, vocab, seed)
    return [a for _ in range(sessions) for a in s.next_session()]


@pytest.mark.parametrize("mix", SERVE)
def test_serving_mix_is_a_pure_function_of_its_seed(mix):
    spec = T.load(MIXES / f"{mix}.json")
    a, b = _asks(spec, 2**33 + 5), _asks(spec, 2**33 + 5)
    assert a == b
    c = _asks(spec, 2**33 + 6)
    assert [x.prompt for x in a] != [x.prompt for x in c]


@pytest.mark.parametrize("mix", SERVE)
def test_serving_lengths_lie_in_the_stated_ranges(mix):
    spec = T.load(MIXES / f"{mix}.json")
    q = spec.get("question")
    for a in _asks(spec, 12345):
        assert spec["output"]["min"] <= a.max_new_tokens <= spec["output"]["max"]
        lo = spec["document"]["min"] + (q["min"] if q else 0)
        hi = spec["document"]["max"] + (q["max"] if q else 0)
        assert lo <= len(a.prompt) <= hi
        assert len(a.prompt) + a.max_new_tokens <= spec["max_seq"]
        assert all(0 <= t < 151936 for t in a.prompt[:64])


@pytest.mark.parametrize("mix", SERVE)
def test_every_seed_gets_the_same_sizes(mix):
    spec = T.load(MIXES / f"{mix}.json")
    pool = spec["pool"]

    def docs(seed):
        s = T.Sessions(spec, 151936, seed)
        return Counter(s._pick("doc", s.doc_sizes, i) for i in range(pool))

    def outs(seed):
        s = T.Sessions(spec, 151936, seed)
        return Counter(s._pick("output", s.out_sizes, i)
                       for i in range(pool))

    assert docs(1) == docs(2**31 + 11) == Counter(
        T.quantiles(spec["document"], pool))
    assert outs(3) == outs(4)
    # a whole block of sessions: the same tokens to prefill and to
    # generate, whatever the seed
    s1, s2 = _asks(spec, 1, pool), _asks(spec, 2, pool)
    assert sum(len(a.prompt) for a in s1) == sum(len(a.prompt) for a in s2)
    assert sorted(a.max_new_tokens for a in s1) == sorted(
        a.max_new_tokens for a in s2)


def test_reask_sessions_share_their_document():
    spec = T.load(MIXES / "serve.longdoc-reask.json")
    s = T.Sessions(spec, 151936, 77)
    asks = s.next_session()
    assert len(asks) == spec["asks_per_document"]
    doc = min(len(a.prompt) for a in asks) - spec["question"]["max"]
    heads = {tuple(a.prompt[:doc]) for a in asks}
    assert len(heads) == 1


def test_quantiles_are_stratified():
    d = {"dist": "loguniform", "min": 1024, "max": 4096}
    q = T.quantiles(d, 4)
    assert q == sorted(q) and q[0] > 1024 and q[-1] < 4096
    assert T.quantiles({"dist": "uniform", "min": 8, "max": 32}, 2) == [14, 26]


@pytest.mark.parametrize("mix", TRAIN)
def test_training_batches_are_a_pure_function_of_seed_and_step(mix):
    spec = dict(T.load(MIXES / f"{mix}.json"), batch=2, seq=16)
    dev = torch.device("cpu")
    a = T.train_batch(spec, 1000, 2**32 + 3, 5, dev)
    b = T.train_batch(spec, 1000, 2**32 + 3, 5, dev)
    c = T.train_batch(spec, 1000, 2**32 + 3, 6, dev)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (2, 16) and int(a["tokens"].max()) < 1000
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert bool((a["labels"][:, -1] == -1).all())
    rows = a["tokens"]
    assert not torch.equal(rows[0], rows[1])


def test_every_mix_file_is_json_a_generator_reads():
    for p in MIXES.iterdir():
        assert p.suffix == ".json", p
        assert json.loads(p.read_text())["kind"] in ("serve", "train")
