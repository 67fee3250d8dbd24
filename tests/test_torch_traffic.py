"""PyTorch port vs JAX reference: the traffic harness's request streams and
trace records (``repro_torch.serve.traffic``, ``serve.request``'s
``to_trace`` / ``from_trace``).

Every case of tests/test_traffic.py, on the port's modules; then the
streams against the reference's for the same arguments — prompts
byte-equal, arrivals float-equal, tasks, budgets and ``make``'s meta equal
(both draw from numpy's ``default_rng(seed)`` in one order) — and a trace
saved by either package replayed by the other.
"""
import json

import numpy as np
import pytest

from repro.serve import traffic as jtraffic
from repro.serve.request import from_trace as jfrom_trace
from repro.serve.request import to_trace as jto_trace
from repro_torch.serve import traffic
from repro_torch.serve.request import Request, from_trace, to_trace


def _stream_fingerprint(reqs):
    return [(round(r.arrival_s, 12), r.task, r.n_new, r.tokens.tolist())
            for r in reqs]


def _exact(reqs):
    """Everything a request carries, unrounded, with the prompt's dtype and
    bytes."""
    return [(r.arrival_s, r.arrival_step, r.task, r.n_new, r.eos_id,
             r.tokens.dtype.str, r.tokens.tobytes(),
             None if r.prefix is None else r.prefix.tobytes())
            for r in reqs]


# ---------------------------------------------- tests/test_traffic.py, ported

def test_poisson_same_seed_identical():
    kw = dict(rate=3.0, n_requests=20, vocab=128, tasks=("a", "b", None),
              prompt_lens=(4, 8), n_new=(4, 8, 12))
    a = traffic.poisson_traffic(seed=7, **kw)
    b = traffic.poisson_traffic(seed=7, **kw)
    assert _stream_fingerprint(a) == _stream_fingerprint(b)
    ts = [r.arrival_s for r in a]
    assert all(t1 > t0 for t0, t1 in zip(ts, ts[1:]))
    assert all(r.n_new in (4, 8, 12) and r.n_prompt in (4, 8) for r in a)


def test_poisson_seed_changes_stream():
    kw = dict(rate=3.0, n_requests=20, vocab=128)
    a = traffic.poisson_traffic(seed=0, **kw)
    b = traffic.poisson_traffic(seed=1, **kw)
    assert _stream_fingerprint(a) != _stream_fingerprint(b)


def test_poisson_rate_validation():
    with pytest.raises(ValueError, match="rate"):
        traffic.poisson_traffic(rate=0.0, n_requests=3, vocab=16)
    with pytest.raises(ValueError, match="n_requests"):
        traffic.poisson_traffic(rate=1.0, n_requests=0, vocab=16)


def test_trace_round_trip(tmp_path):
    reqs = traffic.poisson_traffic(rate=2.0, n_requests=8, vocab=64,
                                   seed=3, tasks=("t0", "t1"), eos_id=5)
    path = str(tmp_path / "trace.json")
    traffic.save_trace(path, reqs)
    back = traffic.load_trace(path)
    assert _stream_fingerprint(back) == _stream_fingerprint(reqs)
    assert all(r.eos_id == 5 for r in back)


def test_trace_prompt_len_synthesis_seeded(tmp_path):
    records = [{"prompt_len": 6, "n_new": 4, "arrival_s": 0.5, "task": "a"},
               {"prompt_len": 3, "n_new": 2, "arrival_s": 1.0}]
    a = from_trace(records, vocab=32, seed=9)
    b = from_trace(records, vocab=32, seed=9)
    c = from_trace(records, vocab=32, seed=10)
    assert _stream_fingerprint(a) == _stream_fingerprint(b)
    assert _stream_fingerprint(a) != _stream_fingerprint(c)
    assert a[0].n_prompt == 6 and a[1].n_prompt == 3
    with pytest.raises(ValueError, match="vocab"):
        from_trace(records)


def test_trace_file_must_be_list(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"nope": 1}, f)
    with pytest.raises(ValueError, match="list"):
        traffic.load_trace(path)


def test_canned_trace_shape():
    reqs = traffic.canned_trace(vocab=64, tasks=("x", "y"), n_requests=12,
                                seed=0)
    assert len(reqs) == 12
    ts = [r.arrival_s for r in reqs]
    assert ts[:4] == [0.0] * 4 and ts[4:8] == [4.0] * 4
    assert ts[8:] == [8.0, 9.0, 10.0, 11.0]
    assert _stream_fingerprint(reqs) == _stream_fingerprint(
        traffic.canned_trace(vocab=64, tasks=("x", "y"), n_requests=12,
                             seed=0))


def test_make_dispatch_and_meta():
    reqs, meta = traffic.make("poisson", vocab=64, seed=4, rate=5.0,
                              n_requests=6)
    assert len(reqs) == 6 and meta["traffic"] == "poisson"
    assert meta["seed"] == 4 and meta["rate"] == 5.0
    reqs_t, meta_t = traffic.make("trace", vocab=64, seed=4, n_requests=6)
    assert meta_t["traffic"] == "trace" and meta_t["path"] == "<canned>"
    with pytest.raises(ValueError, match="unknown traffic"):
        traffic.make("burst", vocab=64)


def test_request_dual_clock_validation():
    with pytest.raises(ValueError, match="pick one clock"):
        Request(tokens=np.arange(4, dtype=np.int32), n_new=2,
                arrival_s=1.0, arrival_step=3)
    with pytest.raises(ValueError):
        Request(tokens=np.arange(4, dtype=np.int32), n_new=2, arrival_s=-1.0)


def test_request_legacy_arrival_alias_not_ported():
    """The reference's deprecated ``arrival=`` alias warns; the port leaves
    it out (its docstring says so): the keyword is refused."""
    with pytest.raises(TypeError, match="arrival"):
        Request(tokens=np.arange(4, dtype=np.int32), n_new=2, arrival=5)
    r = Request(tokens=np.arange(4, dtype=np.int32), n_new=2, arrival_step=5)
    assert r.arrival_step == 5 and r.arrival_s is None


def test_to_trace_json_ready():
    reqs = traffic.canned_trace(vocab=32, n_requests=3, seed=1)
    records = to_trace(reqs)
    json.dumps(records)
    assert [r["arrival_s"] for r in records] == [0.0, 4.0, 8.0]


# ------------------------------------------------- against the reference

POISSON_CASES = [
    dict(rate=3.0, n_requests=20, vocab=128, seed=7, tasks=("a", "b", None),
         prompt_lens=(4, 8), n_new=(4, 8, 12)),
    dict(rate=0.5, n_requests=33, vocab=128256, seed=123,
         prompt_lens=(64, 128, 256), n_new=(16, 32), eos_id=2),
    dict(rate=40.0, n_requests=1, vocab=2, seed=0),
]


@pytest.mark.parametrize("kw", POISSON_CASES)
def test_poisson_equals_reference(kw):
    assert _exact(traffic.poisson_traffic(**kw)) == \
        _exact(jtraffic.poisson_traffic(**kw))


@pytest.mark.parametrize("n,seed,tasks", [(12, 0, ("x", "y")), (3, 1, (None,)),
                                          (25, 9, ("a", "b", "c"))])
def test_canned_trace_equals_reference(n, seed, tasks):
    kw = dict(vocab=50, tasks=tasks, n_requests=n, seed=seed)
    assert _exact(traffic.canned_trace(**kw)) == \
        _exact(jtraffic.canned_trace(**kw))


@pytest.mark.parametrize("kind", ["poisson", "trace"])
def test_make_equals_reference(kind):
    kw = dict(vocab=64, seed=4, tasks=("t0", "t1"), rate=5.0, n_requests=9,
              n_new=(2, 4, 8))
    reqs, meta = traffic.make(kind, **kw)
    jreqs, jmeta = jtraffic.make(kind, **kw)
    assert meta == jmeta
    assert _exact(reqs) == _exact(jreqs)


def test_from_trace_prompt_len_equals_reference():
    records = [{"prompt_len": 6, "n_new": 4, "arrival_s": 0.5, "task": "a"},
               {"tokens": [1, 2, 3], "n_new": 2, "eos_id": 7},
               {"prompt_len": 11, "n_new": 3, "arrival_s": 2.25,
                "prefix": [[0.5, -1.0], [2.0, 0.25]]}]
    got, want = (from_trace(records, vocab=1000, seed=9),
                 jfrom_trace(records, vocab=1000, seed=9))
    assert _exact(got) == _exact(want)
    assert to_trace(got) == jto_trace(want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_file_crosses_packages(tmp_path, writer):
    """A trace saved by either package replays in the other, request for
    request, and the files are byte-equal."""
    kw = dict(rate=2.0, n_requests=8, vocab=64, seed=3, tasks=("t0", "t1"),
              eos_id=5)
    reqs = traffic.poisson_traffic(**kw)
    jreqs = jtraffic.poisson_traffic(**kw)
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    traffic.save_trace(mine, reqs)
    jtraffic.save_trace(theirs, jreqs)
    assert open(mine).read() == open(theirs).read()
    path = mine if writer == "port" else theirs
    assert _exact(traffic.load_trace(path)) == _exact(jtraffic.load_trace(path))
    assert _exact(traffic.load_trace(path)) == _exact(reqs)
