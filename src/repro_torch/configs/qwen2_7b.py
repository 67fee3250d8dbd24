"""qwen2-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, rope_theta=1000000.0,
        qkv_bias=True,
    )
