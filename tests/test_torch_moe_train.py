"""PyTorch port vs JAX reference: training the moe family — 3 train steps
of ``repro.train.step.build_train_step`` against the port's
``train.step.build_train_step`` on the same start and batches, the loss
carrying ``router_aux_coef`` × the Switch aux loss.

Configurations: ``make_tiny`` of mixtral-8x7b and deepseek-moe-16b
(``test_torch_moe.py``), under ``peqa`` (only the scales move — the
router, codes, zeros, norms and table stay bit-equal) and ``full`` (every
float leaf moves, the router and the expert stacks included), float32,
remat "block" (the backward recomputes each block's routing) and "none";
2 × 16-token batches of the synthetic corpus, lr 1e-3.

Tolerances, as ``test_torch_train.py``'s float32 cases: the loss rtol
1e-5, the gradient norm rtol 1e-4, the learning rate rtol 1e-7; each
trained leaf's update within 1e-3 of the reference's in ℓ2; every other
leaf bit-equal.  Optimizer-state bytes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import TrainConfig as JTrain
from repro.core import policies as jpolicies
from repro.models import registry as jregistry
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.train import step as jstep
from repro_torch import bridge
from repro_torch.configs.base import OptimConfig, TrainConfig
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import step
from repro_torch.train.state import make_state

from test_torch_moe import flat, policy_tree, tiny_pair

STEPS, B, S = 3, 2, 16
OCFG = dict(lr=1e-3, warmup_steps=1, schedule="linear", weight_decay=0.01)


@pytest.mark.parametrize("arch,mode,remat", [
    ("mixtral-8x7b", "peqa", "block"), ("mixtral-8x7b", "full", "none"),
    ("deepseek-moe-16b", "peqa", "none"),
    ("deepseek-moe-16b", "full", "block")])
def test_train_steps_match_reference(arch, mode, remat):
    jcfg, tcfg = tiny_pair(arch, mode, remat=remat)
    start = policy_tree(arch, mode)
    data = pipeline.PackedLM(synthetic.corpus(tcfg.vocab_size, 2000, seed=4),
                             B, S)
    batches = [data.batch_at(i) for i in range(STEPS)]
    # the reference
    jp = jax.tree.map(jnp.asarray, start)
    jmask = jpolicies.make_mask(jp, jcfg)
    jopt = jmake_optimizer(JOptim(**OCFG), 10)
    jstate = {"params": jp, "opt": jopt.init(jp, jmask), "step": jnp.int32(0)}
    jts = jstep.build_train_step(jregistry.build(jcfg), jcfg,
                                 JTrain(optim=JOptim(**OCFG)), jmask, jopt)
    jhist = []
    for batch in batches:
        jstate, m = jts(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jhist.append({k: float(v) for k, v in m.items()})
    # the port
    model = bridge.to_module(start, tcfg, device="cpu")
    mask = policies.make_mask(model, tcfg)
    opt = make_optimizer(OptimConfig(**OCFG), 10)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(registry.build(tcfg, device="cpu"), tcfg,
                               TrainConfig(optim=OptimConfig(**OCFG)), mask,
                               opt)
    thist = []
    for batch in batches:
        state, m = ts(state, batch)
        thist.append({k: float(v) for k, v in m.items()})
    assert opt.state_bytes(state["opt"]) == jopt.state_bytes(jstate["opt"])
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-7)
    fs, fw, fg = flat(start), flat(jstate["params"]), flat(
        bridge.to_tree(state["params"]))
    assert fw.keys() == fg.keys() == fs.keys()
    trained = [k for k in fw if not np.array_equal(fs[k], fw[k])]
    if mode == "peqa":
        assert trained and all(k.endswith("scale") for k in trained)
    else:
        assert "layers/moe/router/w" in trained
    assert any("/moe/experts" in k for k in trained)
    for key in fw:
        a, b, s0 = fw[key], fg[key], fs[key]
        if key not in trained:
            np.testing.assert_array_equal(b, a, err_msg=key)
            continue
        upd_ref = a.astype(np.float64) - s0
        upd = b.astype(np.float64) - s0
        assert np.linalg.norm(upd - upd_ref) <= \
            1e-3 * np.linalg.norm(upd_ref), key
