"""Roofline report: three terms per (arch × shape × mesh) from the dry-run
records, the dominant one, and the MODEL_FLOPS / counted-FLOPs ratio (port
of ``repro/launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        --results results/dryrun [--markdown results/roofline.md] \
        [--multi-pod] [--tuning peqa] [--link-bw 450e9]

Terms (seconds a step, PER RANK — a dry-run record is one rank's):

    compute    = dot_flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = collective_bytes / --link-bw

The constants are the card the port runs on, an NVIDIA H100 SXM
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` on it
prints ``CARD``), from NVIDIA's datasheet: 989 TFLOP/s of dense bf16 and
3.35 TB/s of HBM3.  The link rate is a flag; its default is NVLink 4's
450 GB/s a direction (900 GB/s bidirectional a GPU), the H100 SXM
datasheet's — a rank's collectives over the whole mesh would cross
slower links than one host's.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

# what the card's nvidia-smi prints (name, power limit): the constants'
# card
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12          # dense bf16, H100 SXM datasheet
HBM_BW = 3.35e12             # HBM3, H100 SXM datasheet
LINK_BW = 450e9              # NVLink 4, H100 SXM: 900 GB/s both ways


def _matrix_params(cfg):
    """(N_total, N_active) matmul params (embeddings excluded)."""
    d, dff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    dh = cfg.d_head
    attn = d * (cfg.n_heads * dh) + 2 * d * (cfg.n_kv_heads * dh) \
        + (cfg.n_heads * dh) * d
    if cfg.family in ("dense", "vlm"):
        mlp = 3 * d * dff if cfg.act == "silu" else 2 * d * dff
        n = L * (attn + mlp)
        return n, n
    if cfg.family == "moe":
        mc = cfg.moe
        dff_e = mc.d_ff_expert or dff
        expert = 3 * d * dff_e
        shared = mc.n_shared_experts * expert
        routed_total = mc.n_experts * expert
        routed_active = mc.top_k * expert
        n_tot = L * (attn + shared + routed_total)
        n_act = L * (attn + shared + routed_active)
        return n_tot, n_act
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        d_in = ssm.expand * d
        heads = d_in // ssm.head_dim
        mamba = d * d_in * 2 + 2 * d * ssm.n_groups * ssm.d_state \
            + d * heads + d_in * d
        every = cfg.attn_every or (L + 1)
        n_apps = L // every
        shared_attn = 2 * d * (cfg.n_heads * dh) * 2 \
            + 2 * (2 * d) * (cfg.n_kv_heads * dh) + 3 * d * dff
        n = L * mamba + shared_attn  # ONE shared block
        compute_n = L * mamba + n_apps * shared_attn
        return n, compute_n
    if cfg.family == "ssm":
        d_in = 2 * d
        mlstm = 3 * d * d_in + d * d_in + 2 * d * cfg.n_heads + d_in * d
        slstm = d * 4 * d + 4 * (d // cfg.n_heads) ** 2 * cfg.n_heads + d * d
        every = cfg.slstm_every or (L + 1)
        n_s = L // every
        n = n_s * slstm + (L - n_s) * mlstm
        return n, n
    if cfg.family == "encdec":
        enc = cfg.enc_layers * (attn + 2 * d * dff)
        dec = L * (2 * attn + 2 * d * dff)
        return enc + dec, enc + dec
    raise ValueError(cfg.family)


def model_flops(cfg, shape, devices: int) -> float:
    """Analytic useful flops per device per step."""
    n_tot, n_act = _matrix_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens / devices
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch / devices


def load_records(results_dir: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok"):
            recs.append(r)
    return recs


def terms(rec: dict, link_bw: float = LINK_BW) -> dict:
    comp = rec["dot_flops"] / PEAK_FLOPS
    mem = rec["hbm_bytes"] / HBM_BW
    coll = rec["collectives"]["total_bytes"] / link_bw
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda kv: kv[1])
    return dict(compute_s=comp, memory_s=mem, collective_s=coll,
                dominant=dom[0], bound_s=dom[1])


def build_table(results_dir: str, multi_pod: bool = False,
                tuning: str = "peqa", link_bw: float = LINK_BW):
    from repro_torch import configs as C
    rows = []
    for rec in load_records(results_dir):
        if rec["multi_pod"] != multi_pod or rec.get("variant") \
                or rec.get("tuning", "peqa") != tuning:
            continue
        cfg = C.get_config(rec["arch"])
        shape = C.SHAPES_BY_NAME[rec["shape"]]
        t = terms(rec, link_bw)
        mf = model_flops(cfg, shape, rec["devices"])
        t["model_flops"] = mf
        t["useful_ratio"] = mf / max(rec["dot_flops"], 1.0)
        # roofline fraction: useful work at peak vs the bounding term
        t["roofline_frac"] = (mf / PEAK_FLOPS) / max(t["bound_s"], 1e-12)
        rows.append({**rec, **t})
    return rows


def to_markdown(rows) -> str:
    hdr = (f"Constants: {CARD} (989 TFLOP/s bf16, 3.35 TB/s HBM3)\n\n"
           "| arch | shape | compute s | memory s | collective s | bound | "
           "MODEL/counted flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac'] * 100:.1f}% |")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tuning", default="peqa")
    ap.add_argument("--link-bw", type=float, default=LINK_BW,
                    help="bytes/s of a rank's link for the collective term "
                         "(default: NVLink 4 on an H100 SXM, 450 GB/s a "
                         "direction)")
    args = ap.parse_args(argv)
    rows = build_table(args.results, args.multi_pod, args.tuning,
                       args.link_bw)
    md = to_markdown(rows)
    print(md)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md + "\n")
    if rows:
        worst = min(rows, key=lambda r: r["roofline_frac"])
        collb = max(rows, key=lambda r: r["collective_s"])
        print(f"\nworst roofline: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline_frac'] * 100:.1f}%)")
        print(f"most collective-bound: {collb['arch']}/{collb['shape']} "
              f"({collb['collective_s']:.4f}s)")
    return rows


if __name__ == "__main__":
    main()
