"""PyTorch port vs JAX reference: the ssm and hybrid families cut and served
on a (data, model) mesh.

Configurations: ``make_tiny`` of xlstm-125m (4 layers, d 64, 4 heads, an
sLSTM every 2) and zamba2-7b (7 Mamba2 layers, d 64, 8 SSM heads of 16,
d_state 8, the shared block every 3: 2 groups and a 1-layer tail), PEQA
4-bit, float32.  The oracle is the reference's UNSHARDED model at the
same weights (its own mesh paths fail in this sandbox, ROADMAP §3).

  * The cut: the shards of model ranks 0..M−1 (M 2 and 4) of a bridged
    model put back together bit for bit (``unshard``); Mamba2's
    ``zproj`` / ``xproj`` / ``dtproj`` column-parallel in whole heads, its
    conv and head vectors cut, ``bproj`` / ``cproj`` whole, ``out_proj``
    row-parallel; the mLSTM's q/k/v/gate column-parallel, ``gi`` / ``gf``
    and the sLSTM's ``sw`` / ``sr`` / ``sb`` whole, both ``down``s
    row-parallel; zamba2's shared block cut as a dense block; every
    recurrent block marked ``mesh_shard``.
  * The rules (``spec_for_path``, ``leaf_kind``'s partial leaves) and the
    refusals (``shard_problems``): both whole configs accepted at (1, 2)
    for PEQA and full, refused where the axis does not divide a head
    count.
  * Serving, from gloo ranks (``_torch_dist_ranks.py::
    recurrent_serve_rank``, one spawn a mesh, one intra-op thread) at
    (1, 2) and (2, 2): ``generate`` with and without logitshard gives the
    reference host ``Engine``'s tokens and the port's unsharded engine's;
    the prefill logits and the state after the prefill, put back together
    from the ranks' blocks, hold to the reference's within rtol 1e-5,
    atol 1e-4; a decode step's model-axis all-reduces are the lookup's,
    the blocks' row-parallel sums and Mamba2's norm sums, and under
    logitshard it gathers no vocab-extent tensor; drain serving over two
    tasks (a swap between them) gives the unsharded engine's tokens; the
    slot pool's leaves are the rank's blocks of ``cache_specs`` under the
    structural model dims; a swap makes no collective and leaves the
    shard equal to the cut of the swapped whole model.
  * The CLI: ``launch.serve --mesh 1,2 --arch zamba2-7b --continuous
    --scheduler drain`` on two gloo ranks.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core.peqa import ref_path
from repro_torch.dist import backend, context, sharding
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import family_workload
from repro_torch.models import registry
from repro_torch.serve import Request

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ARCHS = {"xlstm": "xlstm-125m", "zamba2": "zamba2-7b"}
B, S, N_NEW = 4, 8, 5
CASE_MESH = [(n, k) for n in ARCHS for k in MESHES]
CASE_IDS = [f"{n}-{k}" for n, k in CASE_MESH]


def _cfgs(name):
    arch = ARCHS[name]
    j = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode="peqa"), quant=JQuant(bits=4, n_grid=2))
    t = tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=2))
    return j, t


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's PEQA tree of a configuration (numpy leaves)."""
    jcfg, _ = _cfgs(name)
    key = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(key), jcfg, key)
    return to_numpy(p)


def _model(name):
    _, tcfg = _cfgs(name)
    return tcfg, bridge.to_module(_tree(name), tcfg, device="cpu")


def _requests(cfg):
    """The reference's family workload (prompts of whole chunks, staggered
    arrivals) over tasks t0 and t1 in turn: a drain swaps between them."""
    return [Request(tokens=r.tokens, n_new=r.n_new, task=f"t{i % 2}",
                    arrival_step=r.arrival_step)
            for i, r in enumerate(family_workload(cfg))]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("recurrent"))
    prompt = np.random.default_rng(1).integers(0, 512, (B, S)).astype(
        np.int32)
    ref, cases, reqs = {}, {}, {}
    for name in ARCHS:
        jcfg, tcfg = _cfgs(name)
        p = _tree(name)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), p)
        api = jregistry.build(jcfg)
        jp = jax.tree.map(jnp.asarray, p)
        logits, cache = api.prefill(jp, {"tokens": jnp.asarray(prompt)})
        ref[name] = {
            "tokens": np.asarray(JEngine(api, jp).generate(
                jnp.asarray(prompt), n_new=N_NEW)),
            "logits": np.asarray(logits),
            "state": {k: np.asarray(v) for k, v in cache.items()}}
        cases[name] = tcfg
        reqs[name] = _requests(tcfg)
    out = {"ref": ref, "cases": cases}
    for key, shape in MESHES.items():
        world = shape[0] * shape[1]
        backend.spawn(ranks.recurrent_serve_rank, world, "cpu", shape, tmp,
                      cases, torch.from_numpy(prompt), N_NEW, reqs,
                      threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"recserve{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_generate_matches_reference(run, name, key):
    want = run["ref"][name]
    host = run[key][0][name]["host_tokens"]
    for r in run[key]:
        res = r[name]
        for ls in (True, False):
            np.testing.assert_array_equal(res[f"tokens_{ls}"].numpy(),
                                          want["tokens"])
            assert torch.equal(res[f"tokens_{ls}"], host)
        _close(res["logits"], want["logits"])


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_prefill_state_matches_reference(run, name, key):
    """The ranks' blocks of the state after the prefill, concatenated
    along each leaf's model dim (model ranks) and batch rows (data
    ranks), equal the reference's prefill cache; a leaf every rank holds
    whole (the sLSTM's) is the same on every model rank."""
    rs, want = run[key], run["ref"][name]["state"]
    d, m = MESHES[key]
    for k, w in want.items():
        mdim = rs[0][name]["model_dims"][k]
        bdim = next(i for i, a in enumerate(rs[0][name]["specs"][k])
                    if a == ("data",)) if d > 1 else None
        rows = []
        for dr in range(d):
            blocks = [next(r for r in rs if r["coords"] == (dr, mr))[name]
                      for mr in range(m)]
            parts = [b["state"][k] for b in blocks]
            if mdim < 0:
                assert all(torch.equal(p, parts[0]) for p in parts), k
                rows.append(parts[0])
            else:
                rows.append(torch.cat(parts, dim=mdim))
        got = rows[0] if bdim is None else torch.cat(rows, dim=bdim)
        assert tuple(got.shape) == w.shape, k
        _close(got, w)


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_decode_collectives(run, name, key):
    """A decode step's model-axis all-reduces without logitshard: the
    lookup's 1, xlstm 1 a block (its ``down``), zamba2 2 a Mamba2 block
    (the norm's sum, ``out_proj``) and 2 a shared-block application; the
    logits' one vocab gather, none under logitshard."""
    cfg = run["cases"][name]
    n = cfg.n_layers
    want = 1 + (n if cfg.family == "ssm"
                else 2 * n + 2 * (n // cfg.attn_every))
    for r in run[key]:
        res = r[name]
        assert sum(e["kind"] == "all_reduce" and e["axis"] == "model"
                   for e in res["decode_False"]) == want
        assert context.allgather_extent_count(res["decode_True"],
                                              cfg.vocab_size) == 0
        assert context.allgather_extent_count(res["decode_False"],
                                              cfg.vocab_size) == 1


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_drain_serving_equals_unsharded(run, name, key):
    want = run[key][0][name]["host_drain"]
    for r in run[key]:
        got = r[name]["drain"]
        assert got["tokens"] == want["tokens"]
        assert all(t is not None for t in got["tokens"])
        assert got["steps"] == want["steps"]
        assert got["switches"] == want["switches"] >= 1


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_pool_cache_is_the_rank_block_of_cache_specs(run, name, key):
    cfg, (d, m) = run["cases"][name], MESHES[key]
    for r in run[key]:
        res = r[name]
        assert res["pool_shapes"] == res["spec_shapes"]
        pool, dims = res["pool_shapes"], res["model_dims"]
        if cfg.family == "ssm":
            assert pool["m_S"][3] == cfg.n_heads // m
            assert pool["s_c"][2] == cfg.n_heads        # the sLSTM whole
            assert dims == {"s_c": -1, "s_n": -1, "s_m": -1, "s_h": -1,
                            "m_S": 3}
        else:
            heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            assert pool["ssm"][3] == heads // m
            assert pool["conv"][4] == cfg.ssm.expand * cfg.d_model // m
            assert pool["attn_k"][3] == cfg.n_kv_heads // m
            assert dims == {"attn_k": 3, "attn_v": 3, "ssm": 3, "conv": 4,
                            "ssm_tail": 2, "conv_tail": 3}


@pytest.mark.parametrize("name,key", CASE_MESH, ids=CASE_IDS)
def test_swap_is_local(run, name, key):
    for r in run[key]:
        res = r[name]
        assert res["swap_record"] == []
        assert res["swap_equal"]
        assert res["local_nbytes"] < res["nbytes"]


CUT_M = [(n, m) for n in ARCHS for m in (2, 4)]


@pytest.mark.parametrize("name,m", CUT_M, ids=[f"{n}-{m}" for n, m in CUT_M])
def test_cut_then_unshard_is_the_whole_model(name, m):
    cfg, model = _model(name)
    shards = [sharding.shard_model(model, cfg, context.coords(1, m, 0, r))
              for r in range(m)]
    whole = sharding.unshard(shards)
    mine = dict((*model.named_parameters(), *model.named_buffers()))
    assert sorted(whole) == sorted(mine)
    for n, t in mine.items():
        assert whole[n].dtype == t.dtype and torch.equal(whole[n], t), n
    s1 = shards[1]
    if cfg.family == "ssm":
        ml, sl = s1.mlstm[0][0], s1.slstm[0]
        assert ml.mesh_shard == sl.mesh_shard == (1, m)
        assert ml.wq.tp == ml.gate.tp == "col" and ml.down.tp == "row"
        assert ml.wq.out_features == 2 * cfg.d_model // m
        assert ml.gi.tp is None and ml.gi.out_features == cfg.n_heads
        assert sl.sw.tp is None and sl.sw.out_features == 4 * cfg.d_model
        assert torch.equal(sl.sr.r, model.slstm[0].sr.r)
        assert sl.down.tp == "row" and sl.down.in_features == \
            cfg.d_model // m
    else:
        blk = s1.mamba_groups[0][0]
        d_inner = cfg.ssm.expand * cfg.d_model
        assert blk.mesh_shard == s1.mamba_tail[0].mesh_shard == (1, m)
        for lin in (blk.zproj, blk.xproj, blk.dtproj):
            assert lin.tp == "col"
        assert blk.xproj.out_features == d_inner // m
        assert blk.bproj.tp is None and torch.equal(
            blk.bproj.qw, model.mamba_groups[0][0].bproj.qw)
        assert blk.out_proj.tp == "row"
        assert blk.A_log.shape[-1] == d_inner // cfg.ssm.head_dim // m
        assert torch.equal(blk.gnorm.g, model.mamba_groups[0][0].gnorm.g)
        sh = s1.shared
        assert sh.attn.wq.tp == sh.mlp.up.tp == "col"
        assert sh.attn.wo.tp == sh.mlp.down.tp == "row"
        assert sh.attn.wq.in_features == 2 * cfg.d_model
    flat = {ref_path(n): t
            for n, t in (*model.named_parameters(), *model.named_buffers())}
    assert sharding.validate_for_mesh(flat, {"data": 1, "model": m}) == []


def test_recurrent_rules():
    """Mamba2 follows the shared rules but for B/C; the leaves kept whole
    whose output a rank uses in part are model-partial."""
    spec = sharding.spec_for_path
    for lin in ("zproj", "xproj", "dtproj"):
        assert spec(f"mamba_groups/{lin}/qw", 4) == (None, None, "model")
        assert spec(f"mamba_groups/{lin}/scale", 4) == (None, None, "model")
    assert spec("mamba_groups/conv/w", 4) == (None, None, "model")
    assert spec("mamba_groups/conv/b", 3) == (None, None, "model")
    for leaf in ("A_log", "ssm_D", "dt_bias"):
        assert spec(f"mamba_tail/{leaf}", 2) == (None, "model")
    assert spec("mamba_tail/out_proj/qw", 3) == (None, None, "model")
    assert spec("mamba_tail/out_proj/scale", 3) == ()
    for path in ("mamba_tail/bproj/qw", "mamba_tail/cproj/scale",
                 "mlstm/gi/scale", "slstm/sw/qw", "slstm/sr/r", "slstm/sb/b",
                 "mamba_tail/gnorm/g"):
        assert spec(path, 3) == (), path
    kind = sharding.leaf_kind
    for path in ("mamba_tail/bproj/scale", "mamba_tail/cproj/zero",
                 "mlstm/gi/scale", "mlstm/gf/w", "slstm/sw/scale",
                 "slstm/sr/r", "slstm/sb/b", "mamba_tail/gnorm/g"):
        assert kind(path, 3) == sharding.PARTIAL, path
    assert kind("mlstm/ln/g", 3) == kind("shared/ln1/g", 2) == \
        sharding.REPLICATED
    assert kind("mamba_tail/A_log", 2) == kind("mlstm/wq/scale", 3) == \
        sharding.SHARDED


@pytest.mark.parametrize("arch", list(ARCHS.values()))
@pytest.mark.parametrize("mode", ["peqa", "full"])
def test_whole_configs_accepted_on_a_mesh(arch, mode):
    """The whole configurations (xlstm-125m: 4 heads; zamba2-7b: 32
    attention and 112 SSM heads) serve and train at (1, 2) and are refused
    where the model axis does not divide a head count."""
    cfg = tconfigs.get_config(arch).replace(tuning=TuningConfig(mode=mode))
    registry.check_supported(cfg, mesh=context.coords(1, 2), train=True,
                             batch=8)
    assert sharding.shard_problems(cfg, 4) == []
    assert any(p.startswith("n_heads=") and "model axis (3)" in p
               for p in sharding.shard_problems(cfg, 3))
    if cfg.family == "hybrid":     # 32 attention heads, 112 SSM heads
        assert sharding.shard_problems(cfg, 32) == [
            "the SSM heads=112 is not divisible by the model axis (32)"]


def test_serve_cli_on_a_cpu_mesh(capfd):
    """``--tiny --mesh 1,2 --arch zamba2-7b --continuous --scheduler
    drain``: the tasks tuned here, then two gloo ranks serve their shards
    a staggered two-task stream and pass the continuous gates."""
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--device", "cpu", "--mesh", "1,2", "--arch",
                           "zamba2-7b", "--continuous", "--scheduler",
                           "drain", "--tune-steps", "2"])
    assert exc.value.code in (0, None)
    out = capfd.readouterr().out
    assert "2 ranks over gloo on cpu" in out and "a swap moves" in out
    assert "continuous[drain]" in out and "[serve] continuous OK" in out
