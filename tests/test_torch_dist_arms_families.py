"""PyTorch port vs JAX reference: the ``lora`` and ``qat`` arms of every
family but the dense one, cut and served on a (1, 2) mesh.

Configurations: ``make_tiny`` of llava-next-mistral-7b (vlm: 8 prefix rows
of image embeddings), whisper-medium (encdec: 2 encoder and 2 decoder
layers, 12 frames; its self- and cross-attention both take adapters),
xlstm-125m (ssm: the mLSTM's ``wq`` / ``wk`` / ``wv``), zamba2-7b
(hybrid: the shared block's adapters, applied in each of its groups),
deepseek-moe-16b (moe, experts cut whole: ``"expert"``) and mixtral-8x7b
(moe, d_ff cut: ``"tensor"``), float32, 4 bits, each under ``lora``
(adapters of rank 4 on ``wq`` / ``wk`` / ``wv`` / ``wo`` wherever the
family has them, every ``lora_b`` drawn from N(0, 0.3²) with seeded numpy
so that the adapters change the outputs) and ``qat`` (groups of 16: a row
shard of 32 input columns reads 2 of a linear's groups, an expert stack's
``down`` under ``"tensor"`` too).  The reference builds every tree
(``policies.prepare``); the port's gloo ranks
(``_torch_dist_ranks.py::arms_serve_rank``, one spawn, one intra-op
thread) cut their shard.

  * ``generate`` with and without logitshard (with the family's prefix)
    gives the reference host ``Engine``'s tokens and the port's unsharded
    engine's, and the prefill logits hold to the reference's within rtol
    1e-5, atol 1e-4 (float32: the row-parallel sums, and a row-parallel
    adapter's delta joined to them, add in another order).
  * A decode step's collective record is the same under both arms: the
    adapters and the fake quantizer add no collective.
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
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.dist import backend

import _torch_dist_ranks as ranks
from test_torch_configs import to_numpy
from _torch_threads import _one_torch_thread  # noqa: F401


ARCHS = {"llava": "llava-next-mistral-7b", "whisper": "whisper-medium",
         "xlstm": "xlstm-125m", "zamba2": "zamba2-7b",
         "deepseek": "deepseek-moe-16b", "mixtral": "mixtral-8x7b"}
ARMS = ("lora", "qat")
CASES = [f"{a}_{m}" for a in ARCHS for m in ARMS]
TUNING = dict(lora_rank=4, lora_targets=("wq", "wk", "wv", "wo"))
QAT_GROUP = 16
B, S, N_NEW = 4, 8, 4


def cfgs(name):
    """(reference config, port config) of a case."""
    arch, arm = name.split("_")
    group = QAT_GROUP if arm == "qat" else None
    j = jconfigs.make_tiny(jconfigs.get_config(ARCHS[arch]))
    t = tconfigs.make_tiny(tconfigs.get_config(ARCHS[arch]))
    return (j.replace(tuning=JTuning(mode=arm, **TUNING),
                      quant=JQuant(bits=4, n_grid=2, group_size=group)),
            t.replace(tuning=TuningConfig(mode=arm, **TUNING),
                      quant=QuantConfig(bits=4, n_grid=2, group_size=group)))


@functools.lru_cache(maxsize=None)
def tree(name):
    """The reference's tree of a case (numpy leaves), every ``lora_b``
    drawn from N(0, 0.3²)."""
    jcfg, _ = cfgs(name)
    key = jax.random.PRNGKey(0)
    p, _ = jpolicies.prepare(jregistry.build(jcfg).init(key), jcfg, key)
    p = to_numpy(p)
    rng = np.random.default_rng(11)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "lora_b":
                node[k] = rng.normal(0.0, 0.3, v.shape).astype(v.dtype)
    fill(p)
    return p


def prefix(cfg, rows_b=B, seed=3):
    """The prompt's per-row prefix: image embeddings (vlm), frames
    (encdec), or None."""
    rows = {"vlm": cfg.n_img_tokens, "encdec": cfg.enc_frames}.get(
        cfg.family)
    if rows is None:
        return None
    return np.random.default_rng(seed).normal(
        size=(rows_b, rows, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("armfam"))
    prompt = np.random.default_rng(1).integers(0, 512, (B, S)).astype(
        np.int32)
    ref, cases, prefixes = {}, {}, {}
    for name in CASES:
        jcfg, tcfg = cfgs(name)
        ranks.save_tree(os.path.join(tmp, f"{name}.npz"), tree(name))
        api = jregistry.build(jcfg)
        jp = jax.tree.map(jnp.asarray, tree(name))
        pre = prefix(tcfg)
        batch = {"tokens": jnp.asarray(prompt)}
        jpre = None
        if pre is not None:
            jpre = jnp.asarray(pre)
            batch[api.caps.prefix_key] = jpre
        ref[name] = {
            "tokens": np.asarray(JEngine(api, jp).generate(
                jnp.asarray(prompt), n_new=N_NEW, prefix=jpre)),
            "logits": np.asarray(api.prefill(jp, batch)[0])}
        cases[name] = tcfg
        prefixes[name] = None if pre is None else torch.from_numpy(pre)
    backend.spawn(ranks.arms_serve_rank, 2, "cpu", (1, 2), tmp, cases,
                  torch.from_numpy(prompt), N_NEW, prefixes, "armfam",
                  threads=1)
    return {"ref": ref,
            "ranks": [torch.load(os.path.join(tmp, f"armfam1x2_{r}.pt"),
                                 weights_only=False) for r in range(2)]}


@pytest.mark.parametrize("name", CASES)
def test_generate_matches_reference(run, name):
    want = run["ref"][name]
    host = run["ranks"][0][name]["host_tokens"]
    np.testing.assert_array_equal(host.numpy(), want["tokens"])
    for r in run["ranks"]:
        res = r[name]
        for ls in (True, False):
            np.testing.assert_array_equal(res[f"tokens_{ls}"].numpy(),
                                          want["tokens"])
            np.testing.assert_allclose(res[f"logits_{ls}"].numpy(),
                                       want["logits"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_adds_no_collective(run, arch):
    """The ``lora`` and ``qat`` shards of a family record the same decode
    step: what the PEQA shard records (``tests/test_torch_dist_*.py``)."""
    for r in run["ranks"]:
        for ls in (True, False):
            recs = [[(e["kind"], e["axis"], e["shape"])
                     for e in r[f"{arch}_{arm}"][f"decode_{ls}"]]
                    for arm in ARMS]
            assert recs[0] and recs[0] == recs[1]
