"""PyTorch port vs JAX reference: the dry run over ``meta`` tensors
(``repro_torch.launch.dryrun``), its counter (``launch/step_stats.py``)
and the roofline (``launch/roofline.py``).

  * For every full config and tuning mode at the production mesh (16, 16)
    the reference's ``validate_for_mesh`` of its ``jax.eval_shape`` tree
    finds no problem, and neither does the port's on its meta tree; the
    port refuses a cell only where it refuses it off the mesh too
    (``lora_optq`` without an OPTQ backbone) or where the model axis does
    not divide the query heads: the port cuts whole heads, the
    reference's GSPMD cuts a head's columns (qwen2-7b's 28, starcoder2-7b's
    36 and xlstm-125m's 4 at M = 16; ROADMAP §3).
  * Rank 0's bytes, leaf for leaf, equal the reference's abstract leaves
    cut by its ``spec_for_path`` at (16, 16), save the layout differences
    of ROADMAP §3: Mamba2's ``bproj`` / ``cproj`` whole, a KV head that
    ``kv_share`` ranks hold whole, the row-parallel ``wo``'s adapter, and
    a frozen token or position table, which the port stores in the
    activation dtype (``common.table_dtype``: bf16, the reference's
    float32).
  * At tiny size on a (2, 2) mesh the dry run's parameter bytes by kind
    equal a real ``shard_model``'s of a seeded build; its collective
    counts by kind and axis equal ``mesh_collectives`` and the records of
    a train step, an ``api.prefill`` and ``Engine.decode_collectives``
    (with and without logitshard) on gloo ranks
    (``_torch_dist_ranks.py::dryrun_record_rank``), and for the dense
    family their bytes too.
  * The port's ``model_flops`` equals the reference's for every arch and
    shape.
  * ``--all`` writes a record for every arch × shape × production mesh
    within 60 s here, creating no tensor off ``meta``; the roofline reads
    them; ``--variant`` takes the reference's levers that change a count here.
"""
import collections
import os
import time
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.core.treepath import path_str
from repro.dist import sharding as jsharding
from repro.launch import roofline as jroofline
from repro.models import registry as jregistry
import repro_torch.configs as tconfigs
from repro_torch.configs.base import QuantConfig, ShapeConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core.peqa import ref_path
from repro_torch.dist import backend, context, sharding
from repro_torch.launch import dryrun, roofline, step_stats
from repro_torch.models import registry
from repro_torch.train import step

import _torch_dist_ranks as ranks
from _torch_threads import _one_torch_thread  # noqa: F401


MODES = ("full", "lora", "lora_optq", "qat", "peqa", "peqa_z")
# the query heads the port cuts whole, where the reference's GSPMD cuts a
# head's columns (ROADMAP §3)
WHOLE_HEADS = {"qwen2-7b": 28, "starcoder2-7b": 36, "xlstm-125m": 4}
# the leaves the port lays out its own way (ROADMAP §3)
LAYOUT = ("bproj", "cproj")


def _jtree(arch, mode):
    cfg = jconfigs.get_config(arch).replace(tuning=JTuning(mode=mode))
    api = jregistry.build(cfg)
    rng = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jpolicies.transform(api.init(rng), cfg,
                                                      rng))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_refusals_equal_reference(arch, mode):
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    assert jsharding.validate_for_mesh(_jtree(arch, mode), mesh) == []
    cfg = dryrun.cell_config(arch, mode)
    for shape in tconfigs.shapes_for(arch):
        rec = dryrun.cell_record(cfg, shape, 16, 16)
        assert "sharding_problems" not in rec
        if rec["ok"]:
            continue
        (why,) = rec["refusals"]
        off = None
        try:
            registry.check_supported(cfg)
        except NotImplementedError as e:
            off = str(e)
        if off is not None:
            assert why == off
        else:
            assert why.endswith(f"n_heads={WHOLE_HEADS[arch]} is not "
                                f"divisible by the model axis (16)"), why
    assert (arch in WHOLE_HEADS or mode == "lora_optq") or rec["ok"]


@pytest.mark.parametrize("mode", ("peqa", "lora", "qat"))
@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS
                                  if a not in WHOLE_HEADS])
def test_rank_bytes_equal_reference_cut(arch, mode):
    sizes = {"data": 16, "model": 16}
    want = {}
    for kp, leaf in jax.tree_util.tree_leaves_with_path(_jtree(arch, mode)):
        path = path_str(kp).lstrip("/")
        spec = tuple(jsharding.spec_for_path(path, len(leaf.shape)))
        n = int(np.prod(sharding.local_shape(leaf.shape, spec, sizes)))
        want[path] = n * leaf.dtype.itemsize
    cfg = dryrun.cell_config(arch, mode)
    shard = dryrun.meta_shard(cfg, 16, 16)
    share = shard.kv_share
    got = collections.Counter()
    for name, t in (*shard.named_parameters(), *shard.named_buffers()):
        got[ref_path(name).lstrip("/")] += t.numel() * t.element_size()
    assert got.keys() == want.keys()
    for path, n in want.items():
        parts = path.split("/")
        if any(p in LAYOUT for p in parts) or (
                parts[-2] == "wo" and parts[-1].startswith("lora")):
            continue
        if share > 1 and parts[-2] in ("wk", "wv") and "model" in \
                jsharding.spec_for_path(path, 2):
            assert got[path] == n * share, path   # the KV head whole
            continue
        if parts[-1] in ("emb", "pos") and mode not in ("full", "qat"):
            assert 2 * got[path] == n, path       # frozen: bf16, not f32
            continue
        assert got[path] == n, path


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_model_flops_equal_reference(arch):
    for shape in tconfigs.shapes_for(arch):
        jshape = jconfigs.SHAPES_BY_NAME[shape.name]
        for devices in (256, 512):
            assert roofline.model_flops(tconfigs.get_config(arch), shape,
                                        devices) == \
                jroofline.model_flops(jconfigs.get_config(arch), jshape,
                                      devices)


# ---------------------------------------------------------------------------
# tiny size: the counts against a real cut and recorded steps
# ---------------------------------------------------------------------------

TINY = {"dense": ("llama3.2-1b", "peqa"), "dense_lora": ("llama3.2-1b",
                                                         "lora"),
        "dense_qat": ("llama3.2-1b", "qat"),
        "granite": ("granite-34b", "peqa"),
        "moe": ("deepseek-moe-16b", "peqa"),
        "vlm": ("llava-next-mistral-7b", "peqa"),
        "encdec": ("whisper-medium", "peqa"),
        "ssm": ("xlstm-125m", "peqa"), "hybrid": ("zamba2-7b", "peqa")}
B, S = 4, 8


def _tiny(name):
    arch, mode = TINY[name]
    return tconfigs.make_tiny(tconfigs.get_config(arch)).replace(
        tuning=TuningConfig(mode=mode), quant=QuantConfig(bits=4, n_grid=2),
        dtype="bfloat16")


def _shape(cfg, kind):
    pre = cfg.n_img_tokens if cfg.family == "vlm" else 0
    return ShapeConfig(kind, 24 if kind == "decode" else S + pre, B, kind)


@pytest.mark.parametrize("name", TINY)
def test_tiny_bytes_equal_a_real_cut(name):
    cfg = _tiny(name)
    api = registry.build(cfg, device="cpu")
    model, mask = policies.build(api, 0)
    real = sharding.shard_model(model, cfg, context.coords(2, 2))
    rec = dryrun.cell_record(cfg, _shape(cfg, "train"), 2, 2)
    assert rec["ok"]
    assert rec["param_bytes"] == step_stats.param_bytes(real, mask)
    assert rec["moment_bytes"] == step_stats.moment_bytes(real, mask)
    model_axis = rec["collectives"]["by_axis"]["model"]["count"]
    assert model_axis == step.mesh_collectives(real, cfg, mask)["model"]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dryrec"))
    cases = {n: _tiny(n) for n in TINY}
    backend.spawn(ranks.dryrun_record_rank, 4, "cpu", (2, 2), tmp, cases,
                  B, S, threads=1)
    return torch.load(os.path.join(tmp, "dryrec0.pt"), weights_only=False)


def _tally(entries, with_bytes):
    out = collections.Counter()
    for e in entries:
        n = e.get("count", 1)
        out[(e["kind"], e["axis"])] += e["bytes"] if with_bytes else n
    return out


@pytest.mark.parametrize("what", ["train", "prefill", "decode_False",
                                  "decode_True"])
@pytest.mark.parametrize("name", TINY)
def test_counts_equal_recorded(recorded, name, what):
    cfg = _tiny(name)
    kind = what.split("_")[0]
    rec = dryrun.cell_record(cfg, _shape(cfg, kind), 2, 2,
                             logitshard=what == "decode_True")
    entries = rec["collectives"]["entries"]
    got = recorded[name][what]
    assert _tally(entries, False) == _tally(got, False)
    if cfg.family == "dense":
        assert _tally(entries, True) == _tally(got, True)


def test_variant_flag(tmp_path):
    """``--variant logitshard+bf16r``: the decode step's sampler sends
    scalars instead of gathering the vocab, and the row sums go in bf16
    (half the bytes of the float32 ones)."""
    base, var = (dryrun.main(["--arch", "llama3.2-1b", "--shape",
                              "decode_32k", "--out", str(tmp_path), *extra])
                 for extra in ([], ["--variant", "logitshard+bf16r"]))
    (b,), (v,) = base, var
    assert v["variant"] == "logitshard+bf16r"
    kinds = {(e["kind"], e["axis"]) for e in v["collectives"]["entries"]}
    assert ("all_gather", "model") not in kinds
    assert ("all_gather", "model") in {
        (e["kind"], e["axis"]) for e in b["collectives"]["entries"]}
    sums = [[e for e in r["collectives"]["entries"]
             if e["kind"] == "all_reduce" and e["count"] == 32]
            for r in (b, v)]
    assert sums[1][0]["bytes"] * 2 == sums[0][0]["bytes"]


class _OffMeta(TorchDispatchMode):
    """Notes every op whose result is a tensor off ``meta``."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.made.append(str(func))
        return out


def test_all_runs_on_meta_within_its_seconds(tmp_path, capsys):
    out = str(tmp_path / "dr")
    dryrun.meta_model.cache_clear()
    dryrun.meta_shard.cache_clear()
    guard = _OffMeta()
    t0 = time.perf_counter()
    with guard:
        recs = dryrun.main(["--all", "--out", out])
    assert time.perf_counter() - t0 < 60.0
    assert guard.made == []
    keys = {(r["arch"], r["shape"], r["multi_pod"]) for r in recs}
    assert keys == {(a, s.name, mp) for a, s in tconfigs.all_cells()
                    for mp in (False, True)}
    assert len(os.listdir(out)) == len(keys)
    assert all("refusals" in r for r in recs if not r["ok"])
    rows = roofline.main(["--results", out])
    assert {r["arch"] for r in rows} == {r["arch"] for r in recs
                                         if r["ok"] and not r["multi_pod"]}
    for r in rows:
        assert r["bound_s"] > 0 and 0 < r["useful_ratio"] < 10
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in capsys.readouterr().out
    # a second run resumes past every cell
    assert dryrun.main(["--all", "--out", out]) == recs
