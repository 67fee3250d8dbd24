"""mixtral-8x7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000;
8 experts top-2, sliding-window attention (4096) [arXiv:2401.04088; hf].
Its experts are stored under ``experts`` (``expert_sharding="tensor"``);
the window takes the ring KV cache."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000, rope_theta=1000000.0,
        swa_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, expert_sharding="tensor"),
    )
