"""whisper-medium — 24L enc + 24L dec, d_model=1024 16H (MHA) d_ff=4096
vocab=51865 [arXiv:2212.04356; unverified].  The conv/log-mel frontend is
a stub, as in the reference: callers supply 1500 precomputed frame
embeddings (``frames``, (B, 1500, d_model)).  LayerNorm + GELU, learned
positions (no RoPE), tied decoder embeddings; vocab padded to 51968 (a
multiple of 128)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, enc_layers=24, enc_frames=1500,
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51968, act="gelu", norm_type="layernorm",
        use_rope=False, tie_embeddings=True,
    )
