"""PyTorch port vs JAX reference: the ScaleBank and the resident stack.

The reference quantizes a tiny GQA llama; its tree goes into the port's
model through ``bridge``.  Keys, arrays, the npz files and the resident
stack's rows must then be the same in both packages — exactly, since no
arithmetic separates them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import scale_bank as jsb
from repro_torch import bridge
from repro_torch.core import scale_bank as sb

from test_torch_configs import reference_params, tiny_llama_pair, to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


TASKS = ("t0", "t1", "t2")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_llama_pair()
    _, jq = reference_params(jcfg, seed=4)
    jq_np = to_numpy(jq)
    bank = sb.ScaleBank()
    model = bridge.to_module(jq_np, tcfg, device="cpu")
    bank.add(TASKS[0], model)
    rng = np.random.default_rng(7)
    for t in TASKS[1:]:
        bank.tasks[t] = {k: (v * rng.uniform(0.8, 1.2, v.shape)
                             ).astype(v.dtype)
                         for k, v in bank.tasks[TASKS[0]].items()}
    return jq_np, tcfg, bank


def _model(setup):
    jq_np, tcfg, _ = setup
    return bridge.to_module(jq_np, tcfg, device="cpu")


def _assert_sets_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("include_zero", [False, True])
def test_extract_scales_matches_reference(setup, include_zero):
    jq_np = setup[0]
    want = jsb.extract_scales(jax.tree.map(jnp.asarray, jq_np), include_zero)
    got = sb.extract_scales(_model(setup), include_zero)
    _assert_sets_equal(got, want)
    assert "layers/attn/wq/scale" in got          # no leading slash
    assert got["layers/attn/wq/scale"].shape[0] == setup[1].n_layers


def test_stack_scales_matches_reference(setup):
    bank = setup[2]
    base = sb.extract_scales(_model(setup), include_zero=True)
    sets = [bank.tasks[t] for t in TASKS] + [base]
    want = jsb.stack_scales(base, sets)
    got = sb.stack_scales(base, sets)
    flat = lambda tree: {"/".join(str(k.key) for k in kp): leaf for kp, leaf
                         in jax.tree_util.tree_leaves_with_path(tree)}
    _assert_sets_equal(flat(got), flat(want))
    leaf = got["layers"]["attn"]["wq"]["scale"]
    assert leaf.shape[:2] == (setup[1].n_layers, len(sets))   # (L, T, N, G)
    with pytest.raises(ValueError, match="rank 1"):
        sb.task_stack_dim(1)


def test_resident_stack_row_content(setup):
    """ensure() installs exactly the bank's scale rows (base zeros ride
    along frozen for paths the task set lacks)."""
    bank = setup[2]
    model = _model(setup)
    base = sb.extract_scales(model, include_zero=True)
    rs = sb.ResidentStack(bank, model, capacity=2, device="cpu")
    row = rs.ensure("t1")
    assert rs.names[row] == "t1" and rs.installs == 1
    flat = {"/".join(str(k.key) for k in kp): leaf for kp, leaf
            in jax.tree_util.tree_leaves_with_path(rs.stack)}
    for path, leaf in flat.items():
        want = np.asarray(bank.tasks["t1"].get(path, base[path]))
        got = leaf.select(leaf.dim() - 3, row).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_resident_stack_lru_pinning(setup):
    bank = setup[2]
    rs = sb.ResidentStack(bank, _model(setup), capacity=2, warm=("t0",),
                          device="cpu")
    # empty rows are preferred over evicting a resident task
    r1 = rs.ensure("t1")
    assert rs.names.count(None) == 0 and "t0" in rs.names
    # full + everything pinned -> None (caller decodes a step and retries)
    assert rs.ensure("t2", pinned={"t0", "t1"}) is None
    # pinned rows are never the victim
    r2 = rs.ensure("t2", pinned={"t1"})
    assert r2 != r1 and rs.names[r1] == "t1" and rs.names[r2] == "t2"
    # LRU order: touching t1 makes t2 the next victim
    rs.ensure("t1")
    r0 = rs.ensure("t0", pinned=())
    assert r0 == r2
    with pytest.raises(KeyError):
        rs.ensure("nope")
    with pytest.raises(ValueError, match="duplicate warm"):
        sb.ResidentStack(bank, _model(setup), 2, warm=("t0", "t0"),
                         device="cpu")


def test_bank_written_by_reference_opens_in_port(setup, tmp_path):
    jq_np = setup[0]
    jbank = jsb.ScaleBank(str(tmp_path))
    jbank.add("ref", jax.tree.map(jnp.asarray, jq_np), include_zero=True)
    bank = sb.ScaleBank(str(tmp_path))
    assert bank.stats.payload_bytes_loaded == 0 and "ref" in bank.tasks
    _assert_sets_equal(bank.tasks["ref"], jbank.tasks["ref"])
    # a reference set installs into the port's live model unchanged
    model = _model(setup)
    bank.switch(model, "ref")
    _assert_sets_equal(sb.extract_scales(model, include_zero=True),
                       jbank.tasks["ref"])


def test_bank_written_by_port_opens_in_reference(setup, tmp_path):
    model = _model(setup)
    bank = sb.ScaleBank(str(tmp_path))
    bank.add("port", model)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.npz"]
    jbank = jsb.ScaleBank(str(tmp_path))
    _assert_sets_equal(jbank.tasks["port"], sb.extract_scales(model))
    assert bank.nbytes("port") == jbank.nbytes("port")


def test_corrupt_file_quarantines_its_task_only(setup, tmp_path):
    bank = sb.ScaleBank(str(tmp_path))
    bank.add("good", _model(setup))
    (tmp_path / "broken.npz").write_bytes(b"this is not a zip archive")
    torn = tmp_path / "torn.npz"
    torn.write_bytes((tmp_path / "good.npz").read_bytes()[:100])
    reopened = sb.ScaleBank(str(tmp_path))
    assert sorted(reopened.tasks) == ["broken", "good", "torn"]
    for name in ("broken", "torn"):
        with pytest.warns(RuntimeWarning, match="quarantining"):
            with pytest.raises(KeyError, match="quarantined"):
                reopened.tasks[name]
        assert name in reopened.quarantined and name not in reopened.tasks
    assert reopened.prefetch("broken") is False
    _assert_sets_equal(reopened.tasks["good"], bank.tasks["good"])
    assert reopened.warm_all() == 1


def test_host_tier_lru_and_stats(setup, tmp_path):
    model = _model(setup)
    writer = sb.ScaleBank(str(tmp_path))
    for t in TASKS:
        writer.add(t, model)
    bank = sb.ScaleBank(str(tmp_path), host_capacity=2)
    assert bank.stats.as_dict() == {"host_hits": 0, "disk_loads": 0,
                                    "host_evictions": 0,
                                    "payload_bytes_loaded": 0}
    assert not bank.loaded("t0") and bank.prefetch("t0")
    bank.tasks["t1"]
    bank.tasks["t2"]                   # evicts t0, the least recently used
    assert not bank.loaded("t0") and bank.loaded("t2")
    assert bank.stats.disk_loads == 3 and bank.stats.host_evictions == 1
    bank.tasks["t2"]
    assert bank.stats.host_hits == 1
    bank.tasks["mem"] = writer.tasks["t0"]    # unbacked: never evicted
    bank.host_capacity = 1
    assert bank.loaded("mem")
    assert bank.prefetch("missing") is False


def test_switch_copies_in_place_and_checks_shapes(setup):
    bank = setup[2]
    model = _model(setup)
    wq = model.layers[1].attn.wq.scale
    ptr = wq.data_ptr()
    bank.switch(model, "t2")
    assert wq.data_ptr() == ptr                      # the same parameter
    np.testing.assert_array_equal(
        wq.detach().numpy(), bank.tasks["t2"]["layers/attn/wq/scale"][1])
    bad = dict(bank.tasks["t1"])
    bad["layers/attn/wk/scale"] = bad["layers/attn/wk/scale"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        sb.apply_scales(model, bad)
    # nothing was written: the model still holds t2
    np.testing.assert_array_equal(
        wq.detach().numpy(), bank.tasks["t2"]["layers/attn/wq/scale"][1])
    with pytest.raises(KeyError, match="no task"):
        bank.switch(model, "nope")
