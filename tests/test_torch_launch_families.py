"""PyTorch port vs JAX reference: ``launch.serve --family-smoke`` for every
family (``run_family_smoke``: untasked continuous serving of
``family_workload``, gated on tokens equal to per-request lockstep
``generate`` and no bubble slot-step), on the CPU.

  * dense, vlm, encdec, ssm and hybrid archs: the CLI exits 0;
  * moe: a token's expert output depends on the other rows of its call
    (capacity is per batch, ROADMAP §3), so at the configs' capacity
    factor the gate fails in BOTH packages, on the same requests: on the
    reference's weights carried across by ``bridge`` the port's served and
    lockstep tokens equal the reference's and its verdict is the
    reference's.  At ``capacity_factor=16`` (no drops; the reference's own
    decode-vs-forward setting) the gate passes.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.train.serve import Engine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.serve import ServeConfig
from repro_torch.train.serve import Engine
from _torch_threads import _one_torch_thread  # noqa: F401


MOE = ("mixtral-8x7b", "deepseek-moe-16b")
OTHERS = tuple(a for a in tconfigs.ARCHS if a not in MOE)


@pytest.mark.parametrize("arch", OTHERS)
def test_family_smoke_cli_exits_zero(arch, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--family-smoke", "--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert exc.value.code == 0, out
    assert out.count("tokens==lockstep: True") == 5


def _pair(arch, capacity_factor=None):
    """The CLI's served config in both packages; the reference's PEQA
    weights from PRNGKey(0), carried into the port."""
    args = serve.parse_args(["--arch", arch, "--device", "cpu"])
    tcfg = serve.model_config(args)
    jcfg = jconfigs.make_tiny(jconfigs.get_config(arch)).replace(
        tuning=JTuning(mode="peqa"), quant=JQuant(bits=4, n_grid=4))
    if capacity_factor is not None:
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    rng = jax.random.PRNGKey(0)
    tree, _ = jpolicies.prepare(jregistry.build(jcfg).init(rng), jcfg, rng)
    tree = jax.tree.map(np.asarray, tree)
    jeng = JEngine(jregistry.build(jcfg), jax.tree.map(jnp.asarray, tree))
    teng = Engine(registry.build(tcfg, device="cpu"),
                  bridge.to_module(tree, tcfg, device="cpu"), device="cpu")
    return args, jcfg, tcfg, jeng, teng


def _verdicts(lines):
    return [line.rsplit(" ", 1)[-1] for line in lines
            if "tokens==lockstep" in line]


@pytest.mark.parametrize("arch", MOE)
def test_moe_family_smoke_matches_reference_verdict(arch):
    args, jcfg, tcfg, jeng, teng = _pair(arch)
    lines = []
    ok = serve.run_family_smoke(teng, tcfg, args, log=lines.append)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jok = jserve.run_family_smoke(jeng, jcfg, args)
    assert ok == jok
    assert _verdicts(lines) == _verdicts(buf.getvalue().splitlines())
    # the tokens behind the verdicts: served and lockstep, request by request
    reqs = serve.family_workload(tcfg, seed=args.seed + 11)
    jreqs = jserve.family_workload(jcfg, seed=args.seed + 11)
    rep = teng.serve(reqs, ServeConfig(n_slots=2))
    jrep = jeng.serve(jreqs, jserve.ServeConfig(n_slots=2))
    assert rep.tokens == [None if t is None else [int(x) for x in t]
                          for t in jrep.tokens]
    for r, jr in zip(reqs, jreqs):
        got = teng.generate(r.tokens[None], n_new=r.n_new)
        want = jeng.generate(jnp.asarray(jr.tokens)[None], n_new=jr.n_new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_moe_family_smoke_passes_without_capacity_drops(arch):
    args, _, tcfg, _, teng = _pair(arch, capacity_factor=16.0)
    assert serve.run_family_smoke(teng, tcfg, args, log=lambda m: None)
