"""starcoder2-7b — 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
GQA + RoPE, layernorm + gelu, biased projections [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152, rope_theta=100000.0,
        qkv_bias=True, act="gelu", norm_type="layernorm",
    )
