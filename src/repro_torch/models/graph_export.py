"""Export assigned-arch models as SEIFER ``LayerGraph``s.

The partitioner cuts between residual blocks; each block node carries
  * param_bytes -- bf16 weight bytes resident on a device hosting the block,
  * out_bytes   -- the activation tensor crossing the cut (B, S, d) bf16 for
    full-sequence work, (B, 1, d) per token for decode, plus any recurrent
    state that must migrate with a decode-stage boundary,
  * flops       -- forward FLOPs of the block at the given shape.

This is what makes the SEIFER technique architecture-agnostic: partitioning
and placement consume only this graph.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.models.lm import PATCH_DIM, PATCH_TOKENS
from repro_torch.models.ssm import HEAD_DIM as SSM_HEAD_DIM
from repro_torch.models.ssm import ssm_dims

BF16 = 2


def _attn_params(cfg: ModelConfig) -> int:
    p = cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim + cfg.q_dim * cfg.d_model
    if cfg.qkv_bias:
        p += cfg.q_dim + 2 * cfg.kv_dim
    return p


def _mlp_params(cfg: ModelConfig) -> int:
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    return cfg.d_model * cfg.d_ff * (3 if gated else 2)


def _moe_params(cfg: ModelConfig) -> int:
    return cfg.n_experts * cfg.d_model * cfg.d_ff * 3 + cfg.d_model * cfg.n_experts


def _mamba_params(cfg: ModelConfig) -> int:
    d_in, h, n = ssm_dims(cfg)
    return (
        cfg.d_model * (2 * d_in + 2 * n + h)  # in_proj
        + cfg.ssm_conv_width * (d_in + 2 * n)  # conv
        + d_in * cfg.d_model  # out_proj
        + 3 * h + d_in
    )


def _mlstm_params(cfg: ModelConfig) -> int:
    d, d_in = cfg.d_model, cfg.ssm_expand * cfg.d_model
    return 4 * d * d_in + d * 2 * cfg.n_heads + d_in * d


def _slstm_params(cfg: ModelConfig) -> int:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return d * 4 * d + h * dh * 4 * dh + 4 * d + d * 2 * d + 2 * d * d


def _attn_flops(cfg: ModelConfig, b: int, sq: int, skv: int, *, causal: bool, window: int = 0) -> int:
    """QK^T + PV flops (projections counted via 2*params*tokens)."""
    eff = min(skv, window) if window else skv
    pair = sq * eff if not causal else sq * eff // 2
    return 4 * b * pair * cfg.n_heads * cfg.head_dim


def _block_layers(cfg: ModelConfig, shape: ShapeConfig) -> list[Layer]:
    b = shape.global_batch
    decode = shape.kind == "decode"
    sq = 1 if decode else shape.seq_len
    skv = shape.seq_len
    tokens = b * sq
    act = b * sq * cfg.d_model * BF16  # boundary tensor

    layers: list[Layer] = []

    def attn_layer(i: int, *, window: int = 0, extra: str = "") -> Layer:
        p = _attn_params(cfg)
        f = 2 * p * tokens + _attn_flops(cfg, b, sq, skv, causal=not decode, window=window)
        # a decode-stage boundary carries the hidden + nothing else (KV stays put)
        return Layer(f"attn{extra}.{i}", p * BF16, act, f)

    def mlp_layer(i: int) -> Layer:
        if cfg.is_moe:
            p_tot, p_act = _moe_params(cfg), 3 * cfg.experts_per_token * cfg.d_model * cfg.d_ff
            return Layer(f"moe.{i}", p_tot * BF16, act, 2 * p_act * tokens)
        p = _mlp_params(cfg)
        return Layer(f"mlp.{i}", p * BF16, act, 2 * p * tokens)

    def mamba_layer(i: int) -> Layer:
        p = _mamba_params(cfg)
        d_in, h, n = ssm_dims(cfg)
        f = 2 * p * tokens + 6 * tokens * h * SSM_HEAD_DIM * n  # state update+readout
        # decode boundary also carries the recurrent state of the *cut* layer
        state = b * h * SSM_HEAD_DIM * n * 4 if decode else 0
        return Layer(f"mamba.{i}", p * BF16, act + state, f)

    def xlstm_layer(i: int, kind: str) -> Layer:
        if kind == "slstm":
            p = _slstm_params(cfg)
            f = 2 * p * tokens
            state = b * cfg.d_model * 4 * 4 if decode else 0
        else:
            p = _mlstm_params(cfg)
            d_in = cfg.ssm_expand * cfg.d_model
            dh = d_in // cfg.n_heads
            f = 2 * p * tokens + 4 * tokens * cfg.n_heads * dh * dh
            state = b * cfg.n_heads * (dh + 1) * dh * 4 if decode else 0
        return Layer(f"{kind}.{i}", p * BF16, act + state, f)

    if cfg.family in ("dense", "vlm", "moe"):
        for i in range(cfg.n_layers):
            local = cfg.local_global and i % 2 == 0
            layers.append(attn_layer(i, window=cfg.sliding_window if local else 0))
            layers.append(mlp_layer(i))
    elif cfg.family == "hybrid":
        per = max(cfg.attn_every, 1)
        shared_p = (_attn_params(cfg) + _mlp_params(cfg)) * BF16
        for i in range(cfg.n_layers):
            layers.append(mamba_layer(i))
            if (i + 1) % per == 0:
                # shared block: params live once; model it on its first use
                first = i + 1 == per
                f = 2 * (_attn_params(cfg) + _mlp_params(cfg)) * tokens
                f += _attn_flops(cfg, b, sq, skv, causal=not decode)
                layers.append(Layer(f"shared.{i}", shared_p if first else 0, act, f))
    elif cfg.family == "ssm":
        per = max(cfg.slstm_every, 1)
        for i in range(cfg.n_layers):
            layers.append(xlstm_layer(i, "slstm" if i % per == 0 else "mlstm"))
    elif cfg.family == "audio":
        enc_tokens = b * shape.seq_len  # encoder always sees the full input
        enc_act = b * shape.seq_len * cfg.d_model * BF16
        for i in range(cfg.encoder_layers):
            p = _attn_params(cfg) + _mlp_params(cfg)
            f = 2 * p * enc_tokens + _attn_flops(cfg, b, shape.seq_len, shape.seq_len, causal=False)
            layers.append(Layer(f"enc.{i}", p * BF16, enc_act, f))
        for i in range(cfg.n_layers):
            p = 2 * _attn_params(cfg) + _mlp_params(cfg)  # self + cross + mlp
            f = 2 * p * tokens
            f += _attn_flops(cfg, b, sq, skv, causal=not decode)  # self
            f += _attn_flops(cfg, b, sq, shape.seq_len, causal=False)  # cross
            layers.append(Layer(f"dec.{i}", p * BF16, act, f))
    else:  # pragma: no cover
        raise ValueError(f"unknown family {cfg.family}")

    return layers


def export_graph(cfg: ModelConfig, shape: ShapeConfig) -> LayerGraph:
    """LayerGraph of ``cfg`` at ``shape`` (embedding/head folded into ends)."""
    b = shape.global_batch
    decode = shape.kind == "decode"
    sq = 1 if decode else shape.seq_len
    layers = _block_layers(cfg, shape)
    embed_bytes = cfg.vocab_size * cfg.d_model * BF16
    act = b * sq * cfg.d_model * BF16

    head = Layer(
        "head",
        embed_bytes if not cfg.tie_embeddings else 0,
        b * sq * cfg.vocab_size * (4 if decode else BF16),
        2 * cfg.vocab_size * cfg.d_model * b * sq,
    )
    first = Layer("embed", embed_bytes, act, 0)
    if cfg.family == "vlm":
        first = Layer("embed", embed_bytes + PATCH_DIM * cfg.d_model * BF16, act, 0)
    in_bytes = b * sq * 4  # token ids
    if cfg.family == "audio":
        in_bytes += b * shape.seq_len * cfg.d_model * BF16  # frame embeddings
    if cfg.family == "vlm":
        in_bytes += b * PATCH_TOKENS * PATCH_DIM * BF16
    return LayerGraph(cfg.name, tuple([first] + layers + [head]), in_bytes=in_bytes)
