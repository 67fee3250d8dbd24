"""PyTorch port vs JAX reference: the traffic driver and its telemetry
(``repro_torch.serve.driver``, ``serve.telemetry``).

Configuration: ``tiny_llama_pair()`` (GQA llama, float32, PEQA 4-bit, and
its 4-bit-plane twin for the speculative scheduler), quantized by the
reference and carried across by ``bridge``; two tasks (the base scales and
a seeded scaling of them) in both packages' ``ScaleBank``s.  The same
Poisson and canned-trace streams (``traffic.make``, equal in both
packages: tests/test_torch_traffic.py) go through ``driver.run`` on both
engines under ``resident``, ``drain`` and ``speculative``:

  * ``summarize``'s fields are equal but the two wall-clock ones (greedy
    tokens of float32 paths, a virtual clock fed by tokens);
  * ``stable_metrics`` of the two ``MetricSink`` documents are equal, and
    a second run of the same seed gives the same stable rows.

Then ``MetricSink``'s validation and serialization cases, against the
reference's sink where both apply.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scale_bank as jsb
from repro.models import registry as jregistry
from repro.serve import ServeConfig as JServeConfig
from repro.serve import driver as jdriver
from repro.serve import telemetry as jtelemetry
from repro.serve import traffic as jtraffic
from repro.train.serve import Engine as JEngine
from repro_torch import bridge
from repro_torch.core import scale_bank as sb
from repro_torch.models import registry
from repro_torch.serve import ServeConfig, driver, telemetry, traffic
from repro_torch.train.serve import Engine

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


TASKS = ("taskA", "taskB")
WALL = ("wall_s", "tok_s_wall")
# (scheduler, layout) of each served case
CASES = [("resident", "nibble"), ("drain", "nibble"),
         ("speculative", "plane")]
KINDS = ("poisson", "trace")


def _setup(layout):
    jcfg, tcfg = tiny_llama_pair(layout=layout)
    _, jq = reference_params(jcfg, seed=0)
    jq_np = to_numpy(jq)
    base = jsb.extract_scales(jq)
    rng = np.random.default_rng(5)
    sets = {TASKS[0]: base,
            TASKS[1]: {k: (v * rng.uniform(0.8, 1.2, v.shape)).astype(v.dtype)
                       for k, v in base.items()}}
    return jcfg, tcfg, jq_np, sets


@pytest.fixture(scope="module")
def setups():
    return {layout: _setup(layout) for layout in ("nibble", "plane")}


def _engines(setup):
    jcfg, tcfg, jq_np, sets = setup
    jbank, tbank = jsb.ScaleBank(), sb.ScaleBank()
    for t, s in sets.items():
        jbank.tasks[t] = s
        tbank.tasks[t] = s
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, jq_np),
                   bank=jbank)
    teng = Engine(registry.build(tcfg, device="cpu"),
                  bridge.to_module(jq_np, tcfg, device="cpu"), bank=tbank,
                  device="cpu")
    return jeng, teng


def _streams(kind, vocab, seed=3):
    kw = dict(vocab=vocab, seed=seed, tasks=TASKS, rate=2.0, n_requests=12)
    return traffic.make(kind, **kw), jtraffic.make(kind, **kw)


def _serve(setups, sched, layout, kind, seed=3):
    """(reference (report, summary, sink), port's) for one case."""
    jeng, teng = _engines(setups[layout])
    (reqs, meta), (jreqs, jmeta) = _streams(kind, setups[layout][1].vocab_size,
                                            seed)
    assert meta == jmeta
    cfg = dict(n_slots=3, scheduler=sched)
    jsink, tsink = jtelemetry.MetricSink(), telemetry.MetricSink()
    jrep, jsum = jdriver.run(jeng, jreqs, JServeConfig(**cfg), sink=jsink)
    trep, tsum = driver.run(teng, reqs, ServeConfig(**cfg), sink=tsink)
    return (jrep, jsum, jsink, meta), (trep, tsum, tsink, meta)


@pytest.fixture(scope="module")
def runs(setups):
    return {(s, l, k): _serve(setups, s, l, k) for s, l in CASES
            for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sched,layout", CASES)
def test_summary_equals_reference(runs, sched, layout, kind):
    (jrep, jsum, _, _), (trep, tsum, _, _) = runs[sched, layout, kind]
    assert trep.scheduler == jrep.scheduler == sched
    assert trep.tokens == jrep.tokens
    assert tsum.keys() == jsum.keys()
    for key in tsum:
        if key not in WALL:
            # exact, NaN (an empty percentile set) equal to NaN
            np.testing.assert_equal(tsum[key], jsum[key], err_msg=key)
    assert tsum["n_served"] == len(trep.requests)
    assert tsum["tok_s_wall"] > 0 and tsum["wall_s"] > 0
    if sched == "speculative":
        assert tsum["draft_steps"] > 0 and tsum["acceptance_rate"] is not None
    if sched == "resident":
        assert tsum["task_drain_idle_slot_steps"] == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sched,layout", CASES)
def test_stable_metrics_equal_reference(runs, tmp_path, sched, layout, kind):
    (_, _, jsink, meta), (_, _, tsink, _) = runs[sched, layout, kind]
    jpath, tpath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    run = {("trace_path" if k == "path" else k): v for k, v in meta.items()}
    jsink.write(jpath, **run)
    tsink.write(tpath, **run)
    jdoc, tdoc = jtelemetry.load(jpath), telemetry.load(tpath)
    assert tdoc["schema"] == jdoc["schema"] == telemetry.SCHEMA_VERSION
    assert tdoc["run"] == jdoc["run"]
    assert telemetry.stable_metrics(tdoc) == jtelemetry.stable_metrics(jdoc)
    assert [m["name"] for m in tdoc["metrics"]] == \
        [m["name"] for m in jdoc["metrics"]]
    walls = [m for m in tdoc["metrics"] if m.get("wall")]
    assert [m["name"] for m in walls] == [f"serving/{sched}_tok_s"]
    # each package reads the other's document
    assert telemetry.stable_metrics(telemetry.load(jpath)) == \
        jtelemetry.stable_metrics(jtelemetry.load(tpath))


def test_same_seed_rerun_has_equal_stable_rows(setups, runs, tmp_path):
    """The reproducibility contract: a second run of the same seed on a
    fresh engine writes the same stable rows."""
    _, (_, _, first, meta) = runs["resident", "nibble", "poisson"]
    _, teng = _engines(setups["nibble"])
    reqs, _ = traffic.make("poisson", vocab=setups["nibble"][1].vocab_size,
                           seed=3, tasks=TASKS, rate=2.0, n_requests=12)
    second = telemetry.MetricSink()
    driver.run(teng, reqs, ServeConfig(n_slots=3, scheduler="resident"),
               sink=second)
    paths = [str(tmp_path / f"{i}.json") for i in range(2)]
    first.write(paths[0], **meta)
    second.write(paths[1], **meta)
    docs = [telemetry.load(p) for p in paths]
    assert telemetry.stable_metrics(docs[0]) == \
        telemetry.stable_metrics(docs[1])


def test_seed_changes_the_stable_rows(setups, runs):
    _, (_, tsum, _, _) = runs["drain", "nibble", "poisson"]
    _, teng = _engines(setups["nibble"])
    reqs, _ = traffic.make("poisson", vocab=setups["nibble"][1].vocab_size,
                           seed=4, tasks=TASKS, rate=2.0, n_requests=12)
    _, other = driver.run(teng, reqs, ServeConfig(n_slots=3,
                                                  scheduler="drain"))
    assert other["slo"] != tsum["slo"]


def test_summary_of_an_empty_run(setups):
    _, teng = _engines(setups["nibble"])
    rep, summ = driver.run(teng, [], ServeConfig(n_slots=2))
    assert summ["n_requests"] == 0 and summ["n_served"] == 0
    assert summ["tok_per_target_step"] == 0.0
    sink = telemetry.MetricSink()
    driver.log_summary(sink, summ)
    # NaN percentiles (nothing served) are skipped, not logged
    assert not any("ttft" in m["name"] for m in sink.metrics)
    json.dumps(sink.payload())


# ------------------------------------------------------------- MetricSink

@pytest.mark.parametrize("guard,match", [
    (("up", 0.1), "direction"), (("higher", 1.0), "band"),
    (("lower", -0.01), "band"), (("lower", 1.5), "band")])
def test_guard_validation(guard, match):
    for sink in (telemetry.MetricSink(), jtelemetry.MetricSink()):
        with pytest.raises(ValueError, match=match):
            sink.log("x", 1.0, "s", guard=guard)
        assert sink.metrics == []


def test_guarded_wall_row_keeps_its_mark():
    rows = []
    for mod in (telemetry, jtelemetry):
        sink = mod.MetricSink()
        e = sink.log("ratio", 0.5, "frac", wall=True, guard=("higher", 0.1))
        assert e["wall"] is True and e["guard"] == {"direction": "higher",
                                                    "band": 0.1}
        sink.log("count", np.int64(3), "req", guard=("lower", 0.0))
        assert mod.stable_metrics(sink.payload()) == [sink.metrics[1]]
        rows.append(sink.payload(seed=np.int32(2)))
    assert rows[0] == rows[1]


def test_torch_and_numpy_scalars_are_coerced(tmp_path):
    sink = telemetry.MetricSink()
    sink.log("t0", torch.tensor(1.5), "s", extra=torch.tensor(3))
    sink.log("t1", torch.tensor([7], dtype=torch.int32), "n")
    sink.log("t2", torch.tensor(True), "bool")
    sink.log("np", np.float32(0.25), "s", flag=np.bool_(True),
             n=np.int16(4))
    with pytest.raises(TypeError, match="scalar"):
        sink.log("bad", torch.zeros(2), "s")
    path = str(tmp_path / "m.json")
    sink.write(path, seed=torch.tensor(5), traffic="poisson")
    doc = telemetry.load(path)
    assert doc["run"] == {"seed": 5, "traffic": "poisson"}
    got = {m["name"]: m for m in doc["metrics"]}
    assert got["t0"]["value"] == 1.5 and got["t0"]["extra"] == 3
    assert got["t1"]["value"] == 7 and got["t2"]["value"] is True
    assert got["np"] == {"name": "np", "value": 0.25, "unit": "s",
                         "flag": True, "n": 4}
    for m in doc["metrics"]:
        for v in m.values():
            assert isinstance(v, (str, int, float, bool, dict))


def test_printer_echoes_rows():
    lines = []
    sink = telemetry.MetricSink(printer=lines.append)
    sink.log("a", 1, "s")
    sink.log("b", 2)
    assert lines == ["a=1 s", "b=2"]


def test_load_pre_schema_and_refuses_no_metrics(tmp_path):
    old = str(tmp_path / "old.json")
    with open(old, "w") as f:
        json.dump({"metrics": [{"name": "x", "value": 1, "unit": ""}]}, f)
    doc = telemetry.load(old)
    assert doc["schema"] == 0 and doc["run"] == {}
    assert doc == jtelemetry.load(old)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"rows": []}, f)
    with pytest.raises(ValueError, match="metrics"):
        telemetry.load(bad)


def test_payload_subset_and_byte_equal_documents(tmp_path):
    docs = []
    for mod in (telemetry, jtelemetry):
        sink = mod.MetricSink()
        sink.log("a", 1.0, "s", guard=("lower", 0.15))
        sink.log("b", 2.0, "tok/s", wall=True)
        sub = sink.payload(sink.metrics[:1], z=1, a="x")
        assert sub["metrics"] == sink.metrics[:1]
        assert list(sub["run"]) == ["a", "z"]
        path = str(tmp_path / f"{mod.__name__}.json")
        sink.write(path, seed=0)
        docs.append(open(path).read())
    assert docs[0] == docs[1]
