"""PyTorch port vs JAX reference: the off-mesh samplers
(``repro_torch.dist.sampling``: ``shard_topk``, ``shard_sample``,
``shard_top_p``, ``_topp_keep``).

The port's Gumbel field is a counter-based integer hash, not the
reference's threefry draws, so the samplers are held to distributions and
rules, not to equal draws:

  * ``shard_topk`` equals ``jax.lax.top_k``, values and indices, ties to the
    lower index;
  * ``temperature <= 0`` is argmax (and p -> 0 is argmax);
  * the field is a pure function of (key, row, vocab index): any slice of
    it is that slice of the whole; it is standard Gumbel (a χ² test);
  * samples follow softmax(l/T): χ² over 20,000 draws from one row (one
    key, 20,000 rows) and over 5,000 keys; top-p samples follow the
    renormalised kept softmax;
  * ``_topp_keep`` equals the reference's on every token whose integer
    weight w is equal in both packages (the weights are computed and
    reported: an ``exp`` one ulp apart can round w the other way), and
    its kept mass meets ⌈p·total⌉ minimally.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.dist import sampling as jsampling
from repro_torch.dist import context, sampling
from _torch_threads import _one_torch_thread  # noqa: F401


# the χ² tests' significance: a fixed hash either passes or fails, so the
# level only bounds how unlucky a correct field may be
ALPHA = 1e-3


def _logits(b, v, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(b, v)) * scale
            ).astype(np.float32)


def _chi2_ok(counts, probs, label):
    """Pearson χ² of ``counts`` against ``probs`` (bins with expected
    count < 5 pooled into one)."""
    n = counts.sum()
    exp = probs * n
    small = exp < 5
    if small.any():
        counts = np.append(counts[~small], counts[small].sum())
        exp = np.append(exp[~small], exp[small].sum())
    chi2 = float(((counts - exp) ** 2 / exp).sum())
    p = float(stats.chi2.sf(chi2, len(exp) - 1))
    print(f"{label}: chi2={chi2:.2f} df={len(exp) - 1} p={p:.4f}")
    assert p > ALPHA, (label, chi2, p)


def _softmax(z):
    z = np.asarray(z, np.float64)
    e = np.exp(z - z.max())
    return e / e.sum()


# ------------------------------------------------------------------- top-k

@pytest.mark.parametrize("k", [1, 5, 17])
def test_topk_equals_lax_top_k_with_ties(k):
    rng = np.random.default_rng(k)
    # integer-valued logits from a small range: many exact ties
    lg = rng.integers(-4, 5, size=(6, 40)).astype(np.float32)
    lg[0] = 1.0                                    # a row of one value
    v, i = sampling.shard_topk(None, 6, k)(torch.from_numpy(lg))
    jv, ji = jsampling.shard_topk(None, 6, k)(jnp.asarray(lg))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_topk_random_logits_equal_reference():
    lg = _logits(8, 300, seed=2)
    v, i = sampling.shard_topk(None, 8, 10)(torch.from_numpy(lg))
    jv, ji = jsampling.shard_topk(None, 8, 10)(jnp.asarray(lg))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ------------------------------------------------------------------ greedy

@pytest.mark.parametrize("make", [
    lambda: sampling.shard_sample(None, 8, 0.0),
    lambda: sampling.shard_sample(None, 8, -1.0),
    lambda: sampling.shard_top_p(None, 8, 0.9, temperature=0.0),
    lambda: sampling.shard_top_p(None, 8, 1e-6, temperature=0.8)],
    ids=["sample_T0", "sample_Tneg", "top_p_T0", "top_p_p_to_0"])
def test_degrades_to_argmax(make):
    lg = _logits(8, 64, seed=1)
    lg[3, 10] = lg[3, 20] = lg[3].max() + 1.0      # a tie: the lower index
    got = make()(torch.from_numpy(lg), 42)
    want = np.asarray(jnp.argmax(jnp.asarray(lg), axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[3]) == 10


def test_mesh_context_and_bad_p_refused():
    """A context that names a mesh position but holds no process groups
    (``context.coords``) is refused when a sharded sampler reduces; the
    sharded forms themselves are tests/test_torch_dist_continuous.py's."""
    ctx = context.coords(1, 2)
    lg = torch.zeros(2, 4)
    for fn in (lambda: sampling.shard_sample(ctx, 2, 0.8)(lg, 0),
               lambda: sampling.shard_top_p(ctx, 2, 0.9)(lg, 0),
               lambda: sampling.shard_topk(ctx, 2, 3)(lg),
               lambda: sampling.shard_argmax(ctx, 2)(lg)):
        with pytest.raises(RuntimeError, match="no process groups"):
            fn()
    with pytest.raises(RuntimeError, match="no process groups"):
        sampling._topp_keep(torch.zeros(1, 4), 8, 0.5, axis=ctx)
    for p in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="top-p"):
            sampling.shard_top_p(None, 2, p)


# ------------------------------------------------------------ Gumbel field

def test_field_slices_equal_the_whole():
    rows, idx = torch.arange(12), torch.arange(100)
    whole = sampling._gumbel_field(7, rows, idx)
    for r0, r1, c0, c1 in ((0, 12, 0, 100), (3, 7, 0, 100), (0, 12, 25, 50),
                           (5, 6, 99, 100), (2, 11, 10, 90)):
        part = sampling._gumbel_field(7, rows[r0:r1], idx[c0:c1])
        assert torch.equal(part, whole[r0:r1, c0:c1])
    # a shard's global coordinates, not its local ones, key its block
    shard = sampling._gumbel_field(7, torch.arange(4) + 8,
                                   torch.arange(50) + 50)
    assert torch.equal(shard, whole[8:12, 50:100])
    # any element alone
    assert torch.equal(sampling._gumbel_field(7, rows[9:10], idx[33:34]),
                       whole[9:10, 33:34])


def test_field_depends_on_key_row_and_index():
    f = sampling._gumbel_field(1, torch.arange(4), torch.arange(64))
    g = sampling._gumbel_field(2, torch.arange(4), torch.arange(64))
    assert (f != g).float().mean() > 0.99
    assert len(torch.unique(f)) > 0.99 * f.numel()
    # a big or negative key folds to 64 bits; distinct keys, distinct fields
    big = sampling._gumbel_field(2 ** 40 + 1, torch.arange(4),
                                 torch.arange(64))
    assert (big != f).float().mean() > 0.99
    assert torch.equal(sampling._gumbel_field(-1, torch.arange(2),
                                              torch.arange(8)),
                       sampling._gumbel_field(2 ** 64 - 1, torch.arange(2),
                                              torch.arange(8)))


def test_field_is_standard_gumbel():
    g = sampling._gumbel_field(5, torch.arange(200), torch.arange(100)
                               ).double().numpy().ravel()
    assert np.isfinite(g).all()
    edges = stats.gumbel_r.ppf(np.linspace(0, 1, 41)[1:-1])
    counts = np.bincount(np.searchsorted(edges, g), minlength=40)
    _chi2_ok(counts, np.full(40, 1 / 40), "gumbel field")


# ------------------------------------------------------------ distributions

@pytest.mark.parametrize("temperature", [0.8, 2.0])
def test_sample_over_rows_follows_softmax(temperature):
    """One fixed row of 16 logits drawn 20,000 times (one key, 20,000
    rows of the field)."""
    row = _logits(1, 16, seed=3, scale=1.0)
    n = 20_000
    lg = torch.from_numpy(np.repeat(row, n, axis=0))
    draws = sampling.shard_sample(None, n, temperature)(lg, 11).numpy()
    _chi2_ok(np.bincount(draws, minlength=16),
             _softmax(row[0] / temperature), f"rows T={temperature}")


def test_sample_over_keys_follows_softmax():
    """One row drawn under 5,000 keys."""
    row = _logits(1, 12, seed=4, scale=1.0)
    fn = sampling.shard_sample(None, 1, 0.8)
    lg = torch.from_numpy(row)
    draws = np.array([int(fn(lg, k)[0]) for k in range(5_000)])
    _chi2_ok(np.bincount(draws, minlength=12), _softmax(row[0] / 0.8),
             "keys")
    # different keys give different samples of a batch (it IS sampling)
    lg8 = torch.from_numpy(_logits(8, 64, seed=1))
    f8 = sampling.shard_sample(None, 8, 0.8)
    assert not torch.equal(f8(lg8, 42), f8(lg8, 43))
    assert torch.equal(f8(lg8, 42), f8(lg8, 42))


def test_top_p_samples_follow_the_kept_softmax():
    row = _logits(1, 32, seed=6, scale=1.5)
    n = 20_000
    z = torch.from_numpy(row) / 0.8
    keep = sampling._topp_keep(z, 32, 0.7)[0].numpy()
    assert 1 < keep.sum() < 32
    lg = torch.from_numpy(np.repeat(row, n, axis=0))
    draws = sampling.shard_top_p(None, n, 0.7, temperature=0.8)(lg, 3).numpy()
    assert keep[draws].all()                       # never outside the nucleus
    probs = _softmax(row[0] / 0.8) * keep
    _chi2_ok(np.bincount(draws, minlength=32)[keep], probs[keep] / probs.sum(),
             "top-p kept softmax")


# -------------------------------------------------------------- top-p mask

def _weights(z):
    gmax = z.max(axis=-1, keepdims=True)
    return np.asarray(jnp.round(jnp.exp(jnp.asarray(z) - gmax)
                                * sampling._TOPP_SCALE).astype(jnp.int32))


@pytest.mark.parametrize("p,temperature,scale", [
    (0.9, 0.8, 3.0), (0.5, 1.0, 1.0), (0.99, 1.3, 6.0), (1.0, 0.7, 2.0),
    (1e-6, 1.0, 3.0), (0.3, 0.5, 0.05)])
def test_topp_keep_equals_reference(p, temperature, scale):
    lg = _logits(64, 500, seed=int(p * 1000) + 7, scale=scale)
    # exact ties in every fourth row
    lg[::4, 1::2] = lg[::4, 0:-1:2]
    z = lg / np.float32(temperature)
    tz = torch.from_numpy(lg) / temperature
    assert np.array_equal(tz.numpy(), z)
    keep = sampling._topp_keep(tz, 500, p).numpy()
    jkeep = np.asarray(jsampling._topp_keep(jnp.asarray(z), 500, p))
    tw = torch.round(torch.exp(tz - tz.amax(-1, keepdim=True))
                     * sampling._TOPP_SCALE).to(torch.int64).numpy()
    jw = _weights(z)
    same_w = tw == jw
    rows_same = same_w.all(axis=1)
    print(f"p={p}: w equal on {same_w.mean():.5f} of tokens, "
          f"{rows_same.sum()} of {len(rows_same)} rows whole; "
          f"max |w diff| {np.abs(tw - jw).max()}")
    assert np.abs(tw - jw).max() <= 1
    assert same_w.mean() > 0.99
    # where a row's weights agree, the masks agree on every token
    assert np.array_equal(keep[rows_same], jkeep[rows_same])
    # and on every token whose weight agrees, in every row
    assert np.array_equal(keep[same_w], jkeep[same_w])


@pytest.mark.parametrize("p", [1e-6, 0.25, 0.5, 0.9, 0.999, 1.0])
def test_topp_kept_mass_meets_target_minimally(p):
    lg = torch.from_numpy(_logits(32, 200, seed=9))
    lg[::3, 1::2] = lg[::3, 0:-1:2]                # ties
    keep = sampling._topp_keep(lg, 200, p)
    w = torch.round(torch.exp(lg - lg.amax(-1, keepdim=True))
                    * sampling._TOPP_SCALE).to(torch.int64)
    total = w.sum(-1)
    tgt = torch.clamp(torch.ceil(p * total.to(torch.float32)).long(), min=1)
    tgt = torch.minimum(tgt, total)
    mass = (w * keep).sum(-1)
    assert (mass >= tgt).all()
    # minimal: drop the lightest kept token and the mass falls short
    lightest = torch.where(keep, w, torch.full_like(w, 1 << 30)).amin(-1)
    assert (mass - lightest < tgt).all()
    # the nucleus is a head of the sorted weights: nothing dropped outweighs
    # anything kept
    dropped_max = torch.where(keep, torch.zeros_like(w), w).amax(-1)
    assert (dropped_max <= lightest).all()
