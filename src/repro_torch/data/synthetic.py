"""Deterministic synthetic corpus with learnable structure (copy of
``repro/data/synthetic.py``: the port imports nothing of the reference).

No network access in this environment (DESIGN.md §6), so Wikitext2/PTB/
Alpaca are stood in for by a Zipf–Markov token stream: unigram frequencies
are Zipfian (like natural text) and each token has a sparse preferred
successor distribution (bigram structure worth ~2 bits).  A model that
learns must beat the unigram entropy; quantization-damaged models measurably
regress — which is what the paper's perplexity tables need to show.
"""
from __future__ import annotations

import numpy as np


def corpus(vocab: int, n_tokens: int, seed: int = 0,
           branch: int = 4, order_mix: float = 0.85) -> np.ndarray:
    """Generate a deterministic token stream (np.int32)."""
    rng = np.random.default_rng(seed)
    # Zipfian unigram distribution
    ranks = np.arange(1, vocab + 1)
    uni = 1.0 / ranks
    uni /= uni.sum()
    # sparse successor table: each token prefers `branch` successors
    succ = rng.integers(0, vocab, size=(vocab, branch))
    succ_w = rng.dirichlet(np.ones(branch) * 0.5, size=vocab)

    out = np.empty(n_tokens, np.int32)
    tok = int(rng.integers(0, vocab))
    unigram_draws = rng.choice(vocab, size=n_tokens, p=uni)
    mix = rng.random(n_tokens)
    branch_pick = rng.random(n_tokens)
    for i in range(n_tokens):
        if mix[i] < order_mix:
            cw = succ_w[tok]
            j = np.searchsorted(np.cumsum(cw), branch_pick[i])
            tok = int(succ[tok, min(j, branch - 1)])
        else:
            tok = int(unigram_draws[i])
        out[i] = tok
    return out


def unigram_entropy(tokens: np.ndarray, vocab: int) -> float:
    counts = np.bincount(tokens, minlength=vocab).astype(np.float64)
    p = counts / counts.sum()
    nz = p > 0
    return float(-(p[nz] * np.log(p[nz])).sum())


def split(tokens: np.ndarray, val_frac: float = 0.1):
    n_val = int(len(tokens) * val_frac)
    return tokens[:-n_val], tokens[-n_val:]
