"""Config dataclasses (copy of ``repro/configs/base.py``'s QuantConfig,
TuningConfig and ModelConfig, trimmed to the fields the port reads or must
refuse, and its MoEConfig, OptimConfig and TrainConfig whole).  Frozen, like the
reference, so they can key caches."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Paper Eq. (1) parameters + storage layout."""

    bits: int = 4
    group_size: Optional[int] = None   # None = per-channel (paper default)
    packed: bool = True
    symmetric: bool = False
    layout: str = "nibble"             # nibble | plane (bit-planes, MSB first)
    quantize_lm_head: bool = False
    n_grid: int = 20                   # RTN range grid-search points

    def spec(self):
        from repro_torch.core.quant import QuantSpec

        return QuantSpec(bits=self.bits, group_size=self.group_size,
                         symmetric=self.symmetric, packed=self.packed,
                         layout=self.layout)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0          # DeepSeek-MoE shared experts
    d_ff_expert: Optional[int] = None  # defaults to ModelConfig.d_ff
    capacity_factor: float = 1.25
    # 'expert': shard expert dim over 'model' (EP; needs n_experts % axis == 0)
    # 'tensor': shard each expert's d_ff over 'model' (TP-within-expert).
    # Off the mesh it names the experts' key: experts_ep / experts
    expert_sharding: str = "tensor"
    router_aux_coef: float = 0.01      # load-balance loss


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """Which fine-tuning method — the paper's comparison axis."""

    mode: str = "peqa"                 # full | lora | lora_optq | qat | peqa | peqa_z
    lora_rank: int = 4
    lora_targets: Tuple[str, ...] = ("wq", "wv")   # QV4; QKVO16 = all 4, r=16
    lora_alpha: float = 1.0
    train_zero_points: bool = False    # Table 17 ablation (peqa_z)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | vlm (the families ported yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False             # qwen2, starcoder2
    act: str = "silu"                  # silu | gelu
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    swa_window: Optional[int] = None   # sliding window: a ring KV cache
    moe: Optional[MoEConfig] = None
    use_rope: bool = True              # learned positions not ported yet
    bf16_reduce: bool = False          # not ported yet: refused by build
    attn_impl: str = "dense"           # dense | chunked (the K4 kernel)
    kv_cache_dtype: str = "model"      # model | int8
    dtype: str = "bfloat16"
    remat: str = "block"               # none | block | full (dots not ported yet)
    n_img_tokens: int = 0              # vlm: patch-embedding prefix length
    quant: QuantConfig = QuantConfig()
    tuning: TuningConfig = TuningConfig()

    @property
    def d_head(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-5                   # paper App H
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 10
    schedule: str = "linear"           # linear (paper) | cosine | constant
    grad_clip: float = 1.0
    grad_compression: Optional[str] = None  # None | 'int8'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 300
    batch_size: int = 8
    seq_len: int = 256
    eval_every: int = 50
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    optim: OptimConfig = OptimConfig()
    watchdog_timeout_s: float = 600.0
