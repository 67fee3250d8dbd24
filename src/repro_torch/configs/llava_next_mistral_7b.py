"""llava-next-mistral-7b — mistral-7b backbone (32L d_model=4096 32H kv=8
d_ff=14336 vocab=32000) + anyres patch-embedding prefix STUB (576 tokens)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  The vision tower is a
stub, as in the reference: callers supply precomputed patch embeddings
(``image_embeds``, (B, 576, d_model))."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000, rope_theta=1000000.0,
        n_img_tokens=576,
    )
