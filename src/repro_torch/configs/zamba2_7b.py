"""zamba2-7b — 81 Mamba2 layers d_model=3584, shared attention block
(32H MHA kv=32, d_ff=14336) applied every 6 layers, ssm_state=64,
vocab=32000 [arXiv:2411.15242; unverified].  Hybrid → runs long_500k."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, rope_theta=10000.0,
        attn_every=6,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
    )
