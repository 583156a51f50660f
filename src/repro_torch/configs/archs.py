"""The 10 assigned architectures, exactly as specified in the assignment.

A copy of the JAX package's ``configs/archs.py``.  Each config is
selectable via ``--arch <id>``; ``get_config`` maps an id or alias to its
ModelConfig.  Sources are noted per config ([hf]/[arXiv] per the assignment
brackets).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# --- [vlm] pixtral-ViT + mistral-nemo backbone -----------------------------
# hf:mistralai/Pixtral-12B-2409 (backbone only; patch frontend is a stub)
PIXTRAL_12B = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="patch",
    sharding="fsdp",
)

# --- [moe] microsoft/Phi-3.5-MoE-instruct: 16 experts, top-2 ---------------
PHI35_MOE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    sharding="ep_fsdp",
)

# --- [moe] Kimi K2: trillion-param MoE, 384 experts top-8 (paper-table) ----
KIMI_K2 = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    rope_theta=50_000.0,
    sharding="fsdp_full",
    opt_state_dtype="bfloat16",  # 1T params: fp32 m,v would not fit 512x16GB
)

# --- [dense] gemma-2b: GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295] --
GEMMA_2B = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_kind="geglu",
    gemma_norm=True,
    sharding="tp",
)

# --- [dense] llama3.2-1b [hf:meta-llama/Llama-3.2-1B] ----------------------
LLAMA32_1B = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500_000.0,
    sharding="tp",
)

# --- [dense] qwen2-7b: GQA + QKV bias [arXiv:2407.10671] -------------------
QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    sharding="tp",
    pad_heads_to=32,  # 28 Q heads don't divide the 16-wide model axis
)

# --- [dense] gemma2-27b: local+global alternating, softcaps [2408.00118] ---
GEMMA2_27B = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    mlp_kind="geglu",
    gemma_norm=True,
    post_norm=True,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    sharding="fsdp",
)

# --- [audio] whisper-small: enc-dec, conv frontend stubbed [2212.04356] ----
WHISPER_SMALL = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_kind="gelu",
    norm_kind="layernorm",
    pos_emb="learned",
    frontend="frames",
    sharding="tp",
)

# --- [ssm] xLSTM-125m: sLSTM + mLSTM blocks [arXiv:2405.04517] -------------
XLSTM_125M = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # mLSTM/sLSTM blocks have internal up/down projections
    vocab_size=50304,
    slstm_every=4,  # blocks 0,4,8 are sLSTM; rest mLSTM (7:1-ish mix)
    ssm_expand=2,
    sharding="tp",
    subquadratic=True,  # recurrent state, O(1) per decoded token
)

# --- [hybrid] zamba2-2.7b: Mamba2 + shared attn [arXiv:2411.15242] ---------
ZAMBA2_27B = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,  # shared attention block's MLP
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    attn_every=6,  # shared attention block applied every 6 mamba blocks
    sharding="tp",
    subquadratic=True,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        PIXTRAL_12B,
        PHI35_MOE,
        KIMI_K2,
        GEMMA_2B,
        LLAMA32_1B,
        QWEN2_7B,
        GEMMA2_27B,
        WHISPER_SMALL,
        XLSTM_125M,
        ZAMBA2_27B,
    )
}
# short aliases for --arch
ALIASES = {
    "pixtral-12b": "pixtral-12b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "kimi-k2": "kimi-k2-1t-a32b",
    "gemma-2b": "gemma-2b",
    "llama3.2-1b": "llama3.2-1b",
    "qwen2-7b": "qwen2-7b",
    "gemma2-27b": "gemma2-27b",
    "whisper-small": "whisper-small",
    "xlstm-125m": "xlstm-125m",
    "zamba2-2.7b": "zamba2-2.7b",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]
