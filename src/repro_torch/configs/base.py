"""Config system: architecture + shape + sharding descriptors.

A copy of the JAX package's ``configs/base.py`` (framework-neutral data; the
port imports nothing of that package).  Every assigned architecture is a
``ModelConfig`` in its own module under ``repro_torch/configs``;
``archs.get_config`` maps ``--arch`` ids to them.  ``reduced()`` derives the
small smoke-test variant of any config.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "vlm", "audio", "ssm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- attention variants ---
    sliding_window: int = 0  # 0 = full attention
    local_global: bool = False  # gemma2: alternate local(sliding)/global
    attn_softcap: float = 0.0  # gemma2 logit soft-capping
    final_softcap: float = 0.0
    qkv_bias: bool = False  # qwen2
    rope_theta: float = 10_000.0
    pos_emb: Literal["rope", "learned"] = "rope"  # whisper: learned

    # --- TP ergonomics ---
    # pad Q heads up to this count (0 = off) so heads shard over the model
    # axis; padded heads have zero-initialized output projections (exact at
    # init).  SPerf iteration: qwen2's 28 heads on a 16-wide axis otherwise
    # replicate attention 16x and all-gather q every layer.
    pad_heads_to: int = 0

    # --- block internals ---
    mlp_kind: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    gemma_norm: bool = False  # (1 + w) RMSNorm scaling + embed * sqrt(d)
    post_norm: bool = False  # gemma2 post-attn/post-ffn extra norms
    tie_embeddings: bool = True

    # --- ssm / hybrid / recurrent ---
    ssm_state: int = 0  # mamba2 state size per head
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0  # zamba2: shared attn block every N mamba blocks
    slstm_every: int = 0  # xlstm: sLSTM block every N blocks (rest mLSTM)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0  # 0 = decoder-only

    # --- modality frontend stub ---
    frontend: Literal["none", "patch", "frames"] = "none"

    # --- distribution defaults ---
    sharding: Literal["tp", "fsdp", "ep", "ep_fsdp", "fsdp_full"] = "tp"
    # optimizer-state dtype: fp32 default; bf16 for the 1T model (documented)
    opt_state_dtype: Literal["float32", "bfloat16"] = "float32"

    # sub-quadratic attention available? (long_500k eligibility)
    subquadratic: bool = False

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.n_experts and not self.experts_per_token:
            raise ValueError("MoE config needs experts_per_token")

    # ------------------------------------------------------------------
    @property
    def padded_heads(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        # attention (when present)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        gated = self.mlp_kind in ("swiglu", "geglu")
        ffn_dense = d * f * (3 if gated else 2)
        if self.family == "ssm":
            d_in = d * self.ssm_expand
            per_layer = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state)
        elif self.family == "hybrid":
            d_in = d * self.ssm_expand
            per_layer = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state)
        elif self.is_moe:
            per_layer = attn + self.n_experts * d * f * 3 + d * self.n_experts
        else:
            per_layer = attn + ffn_dense
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + ffn_dense  # one shared attention+MLP block
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn_dense) + self.n_layers * attn
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * d * f * 3
        return dense + self.n_layers * self.experts_per_token * d * f * 3


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Smoke-test variant: same family/block structure, tiny dims."""
    n_heads = max(2, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // min(ratio, n_heads))
    changes = dict(
        n_layers=max(layers, 2 * cfg.attn_every or layers, 2 * cfg.slstm_every or layers),
        d_model=d_model,
        pad_heads_to=0,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
    )
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every (arch x shape) cell is well-defined
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_cells(cfg: ModelConfig) -> list[str]:
    """Which shape cells run for this arch (long_500k: sub-quadratic only)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        cells.append("long_500k")
    return cells
