"""The port's configs against the reference's, and the helpers the other
parity tests share: the same configuration built in both packages, and
parameters made once by the reference and handed to both as numpy arrays."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import SSMConfig as JSSM
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import TuningConfig as JTuning
from repro.core import policies as jpolicies
from repro.models import registry as jregistry

import repro_torch.configs as tconfigs
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import QuantConfig as TQuant
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.base import TuningConfig as TTuning


def tiny_llama_pair(mode: str = "peqa", **quant):
    """``make_tiny(get_config("llama3.2-1b"))`` with 2 KV heads (GQA) in
    both packages: (reference config, port config)."""
    j = jconfigs.make_tiny(jconfigs.get_config("llama3.2-1b")).replace(
        n_kv_heads=2, tuning=JTuning(mode=mode), quant=JQuant(**quant))
    t = tconfigs.make_tiny(tconfigs.get_config("llama3.2-1b")).replace(
        n_kv_heads=2, tuning=TTuning(mode=mode), quant=TQuant(**quant))
    return j, t


def reference_params(jcfg, seed: int = 0):
    """(fp tree, policy tree) from the reference, as jax arrays."""
    api = jregistry.build(jcfg)
    fp = api.init(jax.random.PRNGKey(seed))
    return fp, jpolicies.transform(fp, jcfg)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def tokens(b: int, s: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _shared_fields(ref, port):
    """(reference values, port values) of the port config's fields,
    recursing into nested configs (the port copies only the fields it
    reads or must refuse)."""
    pairs = {}
    for f in dataclasses.fields(port):
        r, p = getattr(ref, f.name), getattr(port, f.name)
        pairs[f.name] = _shared_fields(r, p) if dataclasses.is_dataclass(p) \
            else (r, p)
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


@pytest.mark.parametrize("make", ["full", "tiny", "paper_lm"])
def test_configs_match_reference(make):
    if make == "full":
        pair = (jconfigs.get_config("llama3.2-1b"),
                tconfigs.get_config("llama3.2-1b"))
    elif make == "tiny":
        pair = tiny_llama_pair()
    else:
        pair = (jconfigs.paper_lm(n_layers=2), tconfigs.paper_lm(n_layers=2))
    ref, port = _shared_fields(*pair)
    assert port == ref
    assert pair[1].d_head == pair[0].d_head


def test_quant_spec_matches_reference():
    for kw in (dict(), dict(bits=3, group_size=128), dict(symmetric=True)):
        js, ts = JQuant(**kw).spec(), TQuant(**kw).spec()
        assert (ts.bits, ts.group_size, ts.symmetric, ts.packed, ts.layout,
                ts.levels, ts.packs) == \
            (js.bits, js.group_size, js.symmetric, js.packed, js.layout,
             js.levels, js.packs)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="llama3.2-1b"):
        tconfigs.get_config("gpt-neo-2.7b")


@pytest.mark.parametrize("kind", ["optim", "train", "ssm"])
def test_training_configs_equal_reference(kind):
    """OptimConfig, TrainConfig and SSMConfig are whole copies: every
    field, every default."""
    ref, port = {"optim": (JOptim(), TOptim()), "train": (JTrain(), TTrain()),
                 "ssm": (JSSM(), TSSM())}[kind]
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert _shared_fields(ref, port)[0] == _shared_fields(ref, port)[1]
    tuning = _shared_fields(JTuning(mode="peqa_z", train_zero_points=True),
                            TTuning(mode="peqa_z", train_zero_points=True))
    assert tuning[0] == tuning[1]


@pytest.mark.parametrize("make", ["full", "tiny"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_recurrent_configs_match_reference(arch, make):
    """xlstm-125m and zamba2-7b field by field (their SSMConfig, and
    ``attn_every`` / ``slstm_every``, included), at full size and through
    ``make_tiny``'s hybrid and ssm branches."""
    ref, port = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if make == "tiny":
        ref, port = jconfigs.make_tiny(ref), tconfigs.make_tiny(port)
    r, p = _shared_fields(ref, port)
    assert p == r
    assert (port.ssm, port.attn_every, port.slstm_every) == (
        TSSM(**dataclasses.asdict(ref.ssm)), ref.attn_every, ref.slstm_every)
    assert port.sub_quadratic == ref.sub_quadratic
