"""xlstm-125m — 12L d_model=768 4H vocab=50304, sLSTM every 4th layer,
mLSTM otherwise (proj-factor 2) [arXiv:2405.04517; unverified].
Pure recurrent → runs long_500k with O(1) state."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, slstm_every=4,
        ssm=SSMConfig(chunk=128),   # chunk length for the mLSTM parallel form
    )
