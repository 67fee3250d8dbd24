"""PyTorch port vs JAX reference: GPipe pipeline parallelism
(``dist/pipeline_par.py::pipeline_apply``).

The reference's test (``tests/test_sharding.py::_PP_TEST``): L = 8 stacked
``tanh(h @ w)`` layers of D = 16 on a batch of 8, here over 2 and 4 stages
(gloo ranks on the CPU, a one-axis ``"stage"`` mesh).  Every rank's output
is held within 1e-5 to the reference's sequential loop, and the ranks'
``torch.autograd`` gradients of the output's sum — each rank's nonzero
only in its own stage's layers — add up to the reference's ``jax.grad``
of the sequential ``lax.scan`` within 1e-5.  The refusals are the
reference's word for word.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import pipeline_par as jpp
from repro_torch.dist import backend
from repro_torch.dist import pipeline_par as tpp

import _torch_dist_ranks as ranks
from _torch_threads import _one_torch_thread  # noqa: F401


L, B, D = 8, 8, 16


def _operands():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L, D, D)).astype(np.float32)
          / np.float32(np.sqrt(D)))
    x = rng.normal(size=(B, D)).astype(np.float32)
    return ws, x


def _sequential(ws, x):
    def seq(w):
        h, _ = jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None),
                            jnp.asarray(x), w)
        return h
    y = seq(jnp.asarray(ws))
    g = jax.grad(lambda w: jnp.sum(seq(w)))(jnp.asarray(ws))
    return np.asarray(y), np.asarray(g)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ws, x = _operands()
    tmp = str(tmp_path_factory.mktemp("pipe"))
    out = {"ref": _sequential(ws, x)}
    for n in (2, 4):
        backend.spawn(ranks.pipeline_rank, n, "cpu", n, tmp,
                      torch.from_numpy(ws), torch.from_numpy(x), threads=1)
        out[n] = [torch.load(os.path.join(tmp, f"pipe{n}_{r}.pt"))
                  for r in range(n)]
    return out


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_sequential(run, n_stages):
    y_ref, g_ref = run["ref"]
    rs = run[n_stages]
    for r in rs:
        assert np.max(np.abs(r["y"].numpy() - y_ref)) < 1e-5
    per = L // n_stages
    for s, r in enumerate(rs):                  # a stage's layers only
        outside = torch.ones(L, dtype=torch.bool)
        outside[s * per:(s + 1) * per] = False
        assert torch.count_nonzero(r["grad"][outside]) == 0
    g = sum(r["grad"] for r in rs).numpy()
    assert np.max(np.abs(g - g_ref)) < 1e-5


def _meshes(names, shape):
    """A stand-in mesh of each package with axes ``names`` of ``shape``
    (the refusals come before any collective)."""
    ref = types.SimpleNamespace(axis_names=names,
                                shape=dict(zip(names, shape)))
    port = types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.empty(shape))
    return ref, port


@pytest.mark.parametrize("names,shape,layers,batch", [
    (("data", "model"), (2, 2), 8, 8),
    (("stage",), (3,), 8, 9),
    (("stage",), (4,), 8, 6),
], ids=["no_stage_axis", "layers", "batch"])
def test_pipeline_refusals_match_reference(names, shape, layers, batch):
    jmesh, tmesh = _meshes(names, shape)
    f = lambda w, h: h
    with pytest.raises(ValueError) as want:
        jpp.pipeline_apply(f, jnp.zeros((layers, 2, 2)),
                           jnp.zeros((batch, 2)), jmesh)
    with pytest.raises(ValueError) as got:
        tpp.pipeline_apply(f, torch.zeros(layers, 2, 2),
                           torch.zeros(batch, 2), tmesh)
    assert str(got.value) == str(want.value)
