"""Config registry (copy of ``repro/configs/__init__.py``'s ``get_config``,
``make_tiny`` and ``paper_lm``, for the families the port serves: the
dense llama3.2-1b, qwen2-7b, granite-34b and starcoder2-7b, the moe
mixtral-8x7b and deepseek-moe-16b, the vlm llava-next-mistral-7b, the
encdec whisper-medium, the ssm xlstm-125m and the hybrid zamba2-7b)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ModelConfig, MoEConfig, OptimConfig,
                                      QuantConfig, SSMConfig, TrainConfig,
                                      TuningConfig)

__all__ = ["ARCHS", "ModelConfig", "MoEConfig", "OptimConfig", "QuantConfig",
           "SSMConfig", "TrainConfig", "TuningConfig", "get_config",
           "make_tiny", "paper_lm"]

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-7b": "qwen2_7b",
    "granite-34b": "granite_34b",
    "starcoder2-7b": "starcoder2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-medium": "whisper_medium",
    "xlstm-125m": "xlstm_125m",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.config()


def make_tiny(cfg: ModelConfig, *, vocab: int = 512) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's
    ``make_tiny``: 2 layers, d_model 64, 4 heads of 16, float32,
    learned-position tables of 512 rows; a vlm's prefix 8 rows; an moe's 8
    experts under ``expert_sharding="expert"``, else 4, top-2, at most one
    shared expert, d_ff 64; an encdec's 2 encoder layers over 12 frames; a
    hybrid's 7 Mamba2 layers, the shared block every 3 — 2 groups and a
    tail layer —, d_state 8, SSM heads of 16, chunk 8; an ssm's 4 layers,
    an sLSTM every 2, chunk 8)."""
    kw = dict(
        name=f"tiny-{cfg.name}", d_model=64, d_ff=0 if cfg.d_ff == 0 else 128,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        vocab_size=vocab, head_dim=16, dtype="float32", max_seq=512,
        n_layers=2)
    if cfg.family == "vlm":
        kw["n_img_tokens"] = 8
    if cfg.family == "moe":
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8 if cfg.moe.expert_sharding == "expert" else 4,
            top_k=2, n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_expert=None)
        kw["d_ff"] = 64
    if cfg.family == "hybrid":
        kw["n_layers"] = 7          # 2 groups of 3 + 1 tail layer
        kw["attn_every"] = 3
        kw["ssm"] = SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8)
    if cfg.family == "ssm":
        kw["n_layers"] = 4
        kw["slstm_every"] = 2
        kw["ssm"] = SSMConfig(chunk=8)
    if cfg.family == "encdec":
        kw["enc_layers"] = 2
        kw["enc_frames"] = 12
    return cfg.replace(**kw)


def paper_lm(name: str = "llama-tiny", *, n_layers: int = 4, d_model: int = 256,
             n_heads: int = 4, d_ff: int = 1024, vocab: int = 512,
             **kw) -> ModelConfig:
    """The paper's own LLaMA-family shape, scaled for CPU experiments.
    Defaults to full-precision tuning (callers opt INTO peqa)."""
    kw.setdefault("tuning", TuningConfig(mode="full"))
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=d_ff, vocab_size=vocab,
        dtype="float32", **kw)
