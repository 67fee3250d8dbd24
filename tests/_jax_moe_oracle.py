"""The reference's MoE block on a (data, model) mesh, run as a script by
``tests/test_torch_dist_moe.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python tests/_jax_moe_oracle.py OUT_DIR

(the device count must be set before jax is imported, so this runs in a
process of its own).  For each case of ``CASES`` it saves the whole tiny
model's PEQA tree (``<case>.npz``, layer 0's block is the one run) and,
for each mesh of ``MESHES``, the block's output ``y`` (B, S, d), its aux
loss, and the gradients of ``sum(y · c) + 10 · aux`` with respect to x
and every float leaf of the block (``<case>_<D>x<M>.npz``).

Per-channel nibble codes run the reference's own sharded ``moe.apply``
under ``dctx.use_mesh``.  Its ``shard_map`` in_specs put the model axis of
a bit-plane leaf (bits, N, K/32) on its bits dim (the shared MLP's, the
``"tensor"`` stacks'), so on planes — and on groups of 32, whose
row-parallel block of scales the port picks by ``tp_groups`` — the oracle
is the reference's unsharded block run on each data block's rows: what
its sharded block computes on per-channel nibbles (capacity and aux are
per data block, the aux averaged over the blocks).
"""
from __future__ import annotations

import os
import sys

import numpy as np

# case: (arch, layout, group size, the reference's own sharded block?)
CASES = {
    "deepseek_nibble": ("deepseek-moe-16b", "nibble", None, True),
    "mixtral_nibble": ("mixtral-8x7b", "nibble", None, True),
    "deepseek_plane": ("deepseek-moe-16b", "plane", None, False),
    "mixtral_plane": ("mixtral-8x7b", "plane", None, False),
    "mixtral_group32": ("mixtral-8x7b", "nibble", 32, False),
}
MESHES = {"deepseek_nibble": ((1, 2), (1, 4), (2, 2)),
          "mixtral_nibble": ((1, 2), (1, 4), (2, 2)),
          "deepseek_plane": ((1, 2), (2, 2)),
          "mixtral_plane": ((1, 2), (2, 2)),
          "mixtral_group32": ((1, 2),)}
B, S, D = 4, 16, 64
AUX_WEIGHT = 10.0


def inputs():
    """The block's input x and the loss's weights c, (B, S, d) float32."""
    g = np.random.default_rng(11)
    return (g.normal(size=(B, S, D)).astype(np.float32),
            g.normal(size=(B, S, D)).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import configs
    from repro.configs.base import QuantConfig, TuningConfig
    from repro.core import policies
    from repro.dist import context as dctx
    from repro.models import moe, registry

    x, c = inputs()
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    for case, (arch, layout, group, own) in CASES.items():
        cfg = configs.make_tiny(configs.get_config(arch)).replace(
            tuning=TuningConfig(mode="peqa"),
            quant=QuantConfig(bits=4, n_grid=2, layout=layout,
                              group_size=group))
        rng = jax.random.PRNGKey(3)
        params, _ = policies.prepare(registry.build(cfg).init(rng), cfg, rng)
        tree = jax.tree.map(np.asarray, params)
        np.savez(os.path.join(out_dir, f"{case}.npz"), **_flat(tree))
        block = jax.tree.map(lambda a: jnp.asarray(a[0]),
                             tree["layers"]["moe"])

        def sharded(bp, xx):
            y, aux = moe.apply(bp, xx, cfg)
            return jnp.sum(y * cj) + AUX_WEIGHT * aux, (y, aux)

        def per_block(n_data):
            def fn(bp, xx):
                ys, auxes = [], []
                for d in range(n_data):
                    rows = slice(d * B // n_data, (d + 1) * B // n_data)
                    y, aux = moe.apply(bp, xx[rows], cfg)
                    ys.append(y)
                    auxes.append(aux)
                y = jnp.concatenate(ys)
                aux = sum(auxes) / n_data
                return jnp.sum(y * cj) + AUX_WEIGHT * aux, (y, aux)
            return fn

        for shape in MESHES[case]:
            if own:
                devs = np.array(jax.devices()[:shape[0] * shape[1]])
                ctx = dctx.make_ctx(Mesh(devs.reshape(shape),
                                         ("data", "model")))
                with dctx.use_mesh(ctx):
                    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                        sharded, argnums=(0, 1), has_aux=True,
                        allow_int=True))(block, xj)
            else:
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    per_block(shape[0]), argnums=(0, 1), has_aux=True,
                    allow_int=True))(block, xj)
            grads = {f"grad/{k}": v for k, v in _flat(gp).items()
                     if np.issubdtype(v.dtype, np.floating)}
            np.savez(os.path.join(out_dir, f"{case}_{shape[0]}x{shape[1]}"
                                  f".npz"),
                     y=np.asarray(y), aux=np.asarray(aux), dx=np.asarray(gx),
                     **grads)


if __name__ == "__main__":
    main(sys.argv[1])
