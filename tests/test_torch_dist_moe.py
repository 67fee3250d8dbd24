"""PyTorch port vs JAX reference: the MoE block on a (data, model) mesh —
expert parallelism (deepseek-moe-16b's ``"expert"``: E/M whole experts a
rank, its shared expert a Megatron MLP) and d_ff parallelism
(mixtral-8x7b's ``"tensor"``: every expert's d_ff over the model axis), on
nibble codes and on bit-planes.

The reference runs in a process of its own with 4 host devices
(``tests/_jax_moe_oracle.py``): the tiny configs (``make_tiny``, PEQA,
4 bits), layer 0's block on x (4, 16, 64) float32, its output, aux loss
and the gradients of ``sum(y · c) + 10 · aux`` with respect to x and
every float leaf of the block (router, scales, zeros) — on per-channel
nibbles its own sharded ``moe.apply`` at (1, 2), (1, 4) and (2, 2); on
planes (at (1, 2) and (2, 2)) and on groups of 32 (mixtral at (1, 2): the
row-parallel experts' ``tp_groups``) its unsharded block on each data
block's rows (its ``shard_map`` in_specs cut a plane leaf's bits dim;
ROADMAP §3).  At data 2
the capacity and the aux loss are each data block's, the aux averaged
over the blocks.

The port's gloo ranks (``_torch_dist_ranks.py::moe_block_rank``, one
intra-op thread each) load the same trees, cut their shard and run the
block on their data block's rows, the aux at 1/D in the loss; each
model-partial gradient (the router's, a row-parallel scale's or zero's)
is summed over the model axis and every one over the data axis, as the
train step sums them.  Reassembled in the test's process, everything is
held to the reference at float32 rounding: y and dx within 2e-6 + 1e-5 ·
|ref|, the aux within rtol 1e-6, each gradient leaf within 1e-5 of its
largest magnitude.  The router's gradient is the whole one, once (the
aux's term is not counted M times).  One model-axis all-reduce a block
in the forward (routed plus shared) and one in the backward (dx); the
no-grad forward equals the graph's.

Also here: a task swap on an MoE shard copies only the rank's block and
makes no collective; the partition rule places a bit-plane ``experts_ep``
stack's model axis on E (the reference's rule, on its bits dim), a plane
stack's cut holds whole experts with all their planes, and
``shard_problems``' MoE refusals.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.dist import sharding as jsharding
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core.peqa import ref_path
from repro_torch.dist import backend, context, sharding
from repro_torch.models import registry

import _jax_moe_oracle as oracle
import _torch_dist_ranks as ranks
from _torch_threads import _one_torch_thread  # noqa: F401


HERE = os.path.dirname(os.path.abspath(__file__))
CASE_MESH = [(case, f"{d}x{m}") for case in oracle.CASES
             for d, m in oracle.MESHES[case]]


def port_cfg(arch, layout="nibble", mode="peqa", **kw):
    return tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode),
        quant=QuantConfig(bits=4, n_grid=2, layout=layout, **kw))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe"))
    src = os.path.join(os.path.dirname(HERE), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, *filter(None, [os.environ.get("PYTHONPATH")])]))
    subprocess.run([sys.executable, os.path.join(HERE, "_jax_moe_oracle.py"),
                    tmp], check=True, env=env, timeout=300)
    x, c = (torch.from_numpy(a) for a in oracle.inputs())
    cases = {case: port_cfg(arch, layout, group_size=group)
             for case, (arch, layout, group, _) in oracle.CASES.items()}
    out = {}
    for key in ("1x2", "1x4", "2x2"):
        shape = tuple(int(v) for v in key.split("x"))
        mine = {c_: cfg for c_, cfg in cases.items()
                if shape in oracle.MESHES[c_]}
        world = shape[0] * shape[1]
        backend.spawn(ranks.moe_block_rank, world, "cpu", shape, tmp, mine,
                      x, c, oracle.AUX_WEIGHT, threads=1)
        out[key] = [torch.load(os.path.join(tmp, f"moe{key}_{r}.pt"),
                               weights_only=False) for r in range(world)]
    for case, key in CASE_MESH:
        with np.load(os.path.join(tmp, f"{case}_{key}.npz")) as z:
            out[(case, key)] = {k: z[k] for k in z.files}
    return out


def _model_ranks(rs, data_rank=0):
    return sorted((r for r in rs if r["coords"][0] == data_rank),
                  key=lambda r: r["coords"][1])


def _rows(rs, case, what):
    """``what`` of model rank 0 on each data rank, rows concatenated."""
    data = sorted({r["coords"][0] for r in rs})
    return torch.cat([_model_ranks(rs, d)[0][case][what] for d in data])


def _whole_grads(rs, case):
    """Each gradient leaf of the whole block: a sharded leaf's blocks
    concatenated over the model ranks, every other one the same on all."""
    first = _model_ranks(rs)
    out = {}
    for name, kind in first[0][case]["kinds"].items():
        parts = [r[case]["grads"][name] for r in first]
        if kind == sharding.SHARDED:
            path = ref_path(f"layers.0.moe.{name}")
            dim = sharding.spec_for_path(path, parts[0].dim()).index("model")
            out[name] = torch.cat(parts, dim=dim)
        else:
            for p in parts[1:]:
                torch.testing.assert_close(p, parts[0], rtol=0, atol=0)
            out[name] = parts[0]
    for r in rs:             # every data rank holds data rank 0's sums
        twin = first[r["coords"][1]]
        for name, g in r[case]["grads"].items():
            assert torch.equal(g, twin[case]["grads"][name]), name
    return out


@pytest.mark.parametrize("case,key", CASE_MESH,
                         ids=[f"{c}-{k}" for c, k in CASE_MESH])
def test_mesh_block_matches_reference(run, case, key):
    rs, ref = run[key], run[(case, key)]
    y = _rows(rs, case, "y")
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=1e-5, atol=2e-6)
    for r in rs:     # every model rank holds the reduced rows
        twin = _model_ranks(rs, r["coords"][0])[0]
        assert torch.equal(r[case]["y"], twin[case]["y"])
        assert torch.equal(r[case]["y_no_grad"], r[case]["y"])
    aux = np.mean([float(_model_ranks(rs, d)[0][case]["aux"])
                   for d in sorted({r["coords"][0] for r in rs})])
    np.testing.assert_allclose(aux, ref["aux"], rtol=1e-6)
    dx = _rows(rs, case, "dx")
    np.testing.assert_allclose(dx.numpy(), ref["dx"], rtol=1e-5, atol=2e-6)
    grads = _whole_grads(rs, case)
    want = {k[len("grad/"):].replace("/", "."): v
            for k, v in ref.items() if k.startswith("grad/")}
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("case,key", CASE_MESH,
                         ids=[f"{c}-{k}" for c, k in CASE_MESH])
def test_one_model_reduce_a_block(run, case, key):
    """The routed and shared partial sums are reduced together: one
    model-axis all-reduce in the forward, in the activation dtype, and
    one (x's gradient) in the backward; nothing on the data axis."""
    for r in run[key]:
        for what in ("forward_record", "backward_record"):
            rec = r[case][what]
            assert [(e["kind"], e["axis"], e["dtype"]) for e in rec] == \
                [("all_reduce", "model", "float32")], what


@pytest.mark.parametrize("case,key", CASE_MESH,
                         ids=[f"{c}-{k}" for c, k in CASE_MESH])
def test_task_swap_on_a_moe_shard_is_local(run, case, key):
    """A task swap on an MoE shard (``ScaleBank``'s mesh half) copies the
    rank's block of each scale — an expert-parallel stack's experts, a
    d_ff shard's rows — and makes no collective: the swapped shard equals
    a fresh cut, and a rank moves fewer bytes than the whole task."""
    for r in run[key]:
        swap = r[case]["swap"]
        assert swap["record"] == [] and swap["equal"]
        assert swap["local_nbytes"] < swap["nbytes"]


@pytest.mark.parametrize("case,key", CASE_MESH,
                         ids=[f"{c}-{k}" for c, k in CASE_MESH])
def test_router_gradient_counted_once(run, case, key):
    """The router's gradient is model-partial: the ranks' parts differ
    (each sees its experts or d_ff slice, the aux term at 1/M) and their
    sum is the reference's; M times the aux term would not be."""
    rs = run[key]
    assert _model_ranks(rs)[0][case]["kinds"]["router.w"] == sharding.PARTIAL
    ref = run[(case, key)]["grad/router/w"]
    got = _whole_grads(rs, case)["router.w"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("arch,local", [("deepseek-moe-16b", (4, 4, 64, 2)),
                                        ("mixtral-8x7b", (4, 4, 32, 2))])
def test_plane_stack_cut_holds_whole_experts(arch, local):
    """A bit-plane expert stack (E, bits, N, K/32) is cut on E under
    "expert" — each rank's experts whole, with all their planes — and on
    N under "tensor"; the old rule (the reference's) put the model axis on
    the bits dim of an ``experts_ep`` stack, per layer and layer-stacked."""
    cfg = port_cfg(arch, "plane")
    model = policies.build(registry.build(cfg, device="cpu"), 0)[0]
    key = "experts_ep" if arch == "deepseek-moe-16b" else "experts"
    whole = getattr(model.layers[0].moe, key).up.qw
    assert tuple(whole.shape) == (local[0] * (2 if key == "experts_ep"
                                              else 1), 4, 64, 2)
    parts = []
    for m in range(2):
        shard = sharding.shard_model(model, cfg, context.coords(1, 2, 0, m))
        qw = getattr(shard.layers[0].moe, key).up.qw
        assert tuple(qw.shape) == local
        parts.append(qw)
    dim = 0 if key == "experts_ep" else 2
    assert torch.equal(torch.cat(parts, dim=dim), whole)
    path = f"layers/moe/{key}/up/qw"
    if key == "experts_ep":
        assert sharding.spec_for_path(path, 4, planes=True) == ("model",)
        assert sharding.spec_for_path(path, 5, planes=True) == (None,
                                                                "model")
        assert tuple(jsharding.spec_for_path(path, 4)) == (None, "model")
        assert tuple(jsharding.spec_for_path(path, 5)) == (None, None,
                                                           "model")
        # nibbles: the rule as it was, and the reference's
        for nd in (3, 4):
            assert sharding.spec_for_path(path, nd) == \
                tuple(jsharding.spec_for_path(path, nd))
    specs = sharding.param_specs(model)
    assert specs[f"layers.0.moe.{key}.up.qw"] == \
        (("model",) if key == "experts_ep" else (None, None, "model"))


@pytest.mark.parametrize("arch,change,m,what", [
    ("deepseek-moe-16b", {}, 3, "n_experts=8 is not divisible"),
    ("mixtral-8x7b", {}, 3, "d_ff_expert=64 is not divisible"),
    ("deepseek-moe-16b", {"n_experts": 24}, 3,
     "the shared experts' d_ff=64 is not divisible"),
    ("mixtral-8x7b", {"layout": "plane"}, 4,
     "an expert's down's local input extent 16 is not a whole number of "
     "32-code words"),
    ("mixtral-8x7b", {"group_size": 32}, 4,
     "an expert's down's local input extent 16 is not a whole number of "
     "groups of 32"),
    ("deepseek-moe-16b", {"layout": "plane"}, 4,
     "the shared down's local input extent 16 is not a whole number of "
     "32-code words"),
], ids=["experts", "d_ff_expert", "shared", "plane_word", "group",
        "shared_word"])
def test_unshardable_moe_refused(arch, change, m, what):
    cfg = port_cfg(arch, layout=change.get("layout", "nibble"),
                   **({"group_size": change["group_size"]}
                      if "group_size" in change else {}))
    if "n_experts" in change:
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **{**cfg.moe.__dict__, "n_experts": change["n_experts"]}))
    probs = sharding.shard_problems(cfg, m)
    assert any(what in p for p in probs), probs
    with pytest.raises(NotImplementedError, match="not served on a"):
        registry.check_supported(cfg, mesh=context.coords(1, m))
    with pytest.raises(NotImplementedError, match="cannot shard"):
        model = policies.build(registry.build(cfg, device="cpu"), 0)[0]
        sharding.shard_model(model, cfg, context.coords(1, m))
    assert sharding.shard_problems(cfg, 2) == []     # M = 2 cuts them all
