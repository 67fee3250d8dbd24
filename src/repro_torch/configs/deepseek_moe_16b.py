"""deepseek-moe-16b — 28L d_model=2048 16H (MHA kv=16) expert d_ff=1408
vocab=102400; 64 routed experts top-6 + 2 shared experts (fine-grained)
[arXiv:2401.06066; hf].  Its experts are stored under ``experts_ep``
(``expert_sharding="expert"``).  Simplification, as in the reference:
layer 0 is MoE too (the real checkpoint has one dense layer)."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400, rope_theta=10000.0,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                      expert_sharding="expert"),
    )
