"""Layer graphs of the CNNs used in the paper-style evaluation.

SEIFER's preliminary evaluation (Fig. 3) sweeps several Keras-style vision
models (the DEFER predecessor used VGG16/ResNet-family models).  We
reconstruct their chain layer graphs from the published architectures:
per-layer parameter counts and output activation shapes.  Parameters default
to 1 byte each (the paper quantizes models with TFLite before deployment);
activations default to 4 bytes (float), with an optional compression ratio
applied by the caller (paper: ZFP/LZ4).

These graphs feed ``core.simulate`` and the planner.  ``demo_mlp``,
``demo_ssm`` and ``demo_transformer`` below are the executable models: a
layer graph plus versioned torch executors.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from repro_torch.core.graph import Layer, LayerGraph

PARAM_BYTES = 1  # int8-quantized weights (TFLite), per the paper
ACT_BYTES = 4  # float32 activations on the wire


def _conv(name: str, k: int, cin: int, cout: int, oh: int, ow: int) -> Layer:
    return Layer(
        name=name,
        param_bytes=(k * k * cin * cout + cout) * PARAM_BYTES,
        out_bytes=oh * ow * cout * ACT_BYTES,
        flops=2 * k * k * cin * cout * oh * ow,
    )


def _fc(name: str, cin: int, cout: int) -> Layer:
    return Layer(
        name=name,
        param_bytes=(cin * cout + cout) * PARAM_BYTES,
        out_bytes=cout * ACT_BYTES,
        flops=2 * cin * cout,
    )


def vgg16() -> LayerGraph:
    """VGG16 (224x224x3).  Pooling folded into the preceding conv's output."""
    cfg = [
        # (cin, cout, out_h/w after optional pool)
        (3, 64, 224),
        (64, 64, 112),  # pool
        (64, 128, 112),
        (128, 128, 56),  # pool
        (128, 256, 56),
        (256, 256, 56),
        (256, 256, 28),  # pool
        (256, 512, 28),
        (512, 512, 28),
        (512, 512, 14),  # pool
        (512, 512, 14),
        (512, 512, 14),
        (512, 512, 7),  # pool
    ]
    layers = [
        _conv(f"conv{i}", 3, cin, cout, hw, hw) for i, (cin, cout, hw) in enumerate(cfg)
    ]
    layers += [_fc("fc1", 7 * 7 * 512, 4096), _fc("fc2", 4096, 4096), _fc("fc3", 4096, 1000)]
    return LayerGraph("vgg16", tuple(layers), in_bytes=224 * 224 * 3 * ACT_BYTES)


def _bottleneck(name: str, cin: int, cmid: int, cout: int, hw: int, downsample: bool) -> Layer:
    params = cin * cmid + 9 * cmid * cmid + cmid * cout + (cin * cout if downsample else 0)
    flops = 2 * hw * hw * (cin * cmid + 9 * cmid * cmid + cmid * cout)
    return Layer(
        name=name,
        param_bytes=params * PARAM_BYTES,
        out_bytes=hw * hw * cout * ACT_BYTES,
        flops=flops,
    )


def resnet50() -> LayerGraph:
    layers = [_conv("stem", 7, 3, 64, 112, 112)]
    stages = [  # (blocks, cin, cmid, cout, hw)
        (3, 64, 64, 256, 56),
        (4, 256, 128, 512, 28),
        (6, 512, 256, 1024, 14),
        (3, 1024, 512, 2048, 7),
    ]
    for s, (nblk, cin, cmid, cout, hw) in enumerate(stages):
        for b in range(nblk):
            layers.append(
                _bottleneck(f"s{s}b{b}", cin if b == 0 else cout, cmid, cout, hw, b == 0)
            )
    layers.append(_fc("fc", 2048, 1000))
    return LayerGraph("resnet50", tuple(layers), in_bytes=224 * 224 * 3 * ACT_BYTES)


def inceptionv3() -> LayerGraph:
    """Stage-level InceptionV3 chain (299x299x3): published block output
    shapes; per-block params distributed to match the ~23.8M total."""
    blocks = [  # (name, params, out_h/w, out_c)
        ("stem1", 0.03e6, 147, 32),
        ("stem2", 0.1e6, 147, 64),
        ("stem3", 0.3e6, 71, 192),
        ("mixed0", 0.26e6, 35, 256),
        ("mixed1", 0.28e6, 35, 288),
        ("mixed2", 0.29e6, 35, 288),
        ("mixed3", 1.2e6, 17, 768),
        ("mixed4", 1.3e6, 17, 768),
        ("mixed5", 1.4e6, 17, 768),
        ("mixed6", 1.4e6, 17, 768),
        ("mixed7", 1.6e6, 17, 768),
        ("mixed8", 1.7e6, 8, 1280),
        ("mixed9", 5.0e6, 8, 2048),
        ("mixed10", 6.1e6, 8, 2048),
    ]
    layers = [
        Layer(
            name=n,
            param_bytes=int(p) * PARAM_BYTES,
            out_bytes=hw * hw * c * ACT_BYTES,
            flops=int(p) * 2 * hw * hw,
        )
        for (n, p, hw, c) in blocks
    ]
    layers.append(_fc("fc", 2048, 1000))
    return LayerGraph("inceptionv3", tuple(layers), in_bytes=299 * 299 * 3 * ACT_BYTES)


def _inverted_residual(name: str, cin: int, cout: int, hw: int, expand: int = 6) -> Layer:
    cexp = cin * expand
    params = cin * cexp + 9 * cexp + cexp * cout
    return Layer(
        name=name,
        param_bytes=params * PARAM_BYTES,
        out_bytes=hw * hw * cout * ACT_BYTES,
        flops=2 * hw * hw * params,
    )


def mobilenetv2() -> LayerGraph:
    layers = [_conv("stem", 3, 3, 32, 112, 112)]
    cfg = [  # (cin, cout, hw, repeats)
        (32, 16, 112, 1),
        (16, 24, 56, 2),
        (24, 32, 28, 3),
        (32, 64, 14, 4),
        (64, 96, 14, 3),
        (96, 160, 7, 3),
        (160, 320, 7, 1),
    ]
    for i, (cin, cout, hw, rep) in enumerate(cfg):
        for r in range(rep):
            layers.append(_inverted_residual(f"ir{i}_{r}", cin if r == 0 else cout, cout, hw))
    layers.append(_conv("head", 1, 320, 1280, 7, 7))
    layers.append(_fc("fc", 1280, 1000))
    return LayerGraph("mobilenetv2", tuple(layers), in_bytes=224 * 224 * 3 * ACT_BYTES)


PAPER_MODELS = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "inceptionv3": inceptionv3,
    "mobilenetv2": mobilenetv2,
}


def params_from_numpy(arrays: Mapping[str, Any], device) -> dict:
    """Weights from elsewhere (e.g. the JAX package's, as numpy arrays) as
    float32 tensors on ``device``: ``ws`` for ``demo_mlp``; ``wb``, ``wc``,
    ``wd`` for ``demo_ssm``; ``wqkv``, ``wo``, ``w1``, ``w2`` for
    ``demo_transformer``."""
    import numpy as np
    import torch

    return {name: torch.tensor(np.asarray(a, np.float32), device=device)
            for name, a in arrays.items()}


def _weights(params_for_version, version: int, device, draw) -> dict:
    """Version -> weight tensors: the caller's arrays when given, else drawn
    by ``draw(generator)`` from ``torch.Generator(device).manual_seed``."""
    import torch

    if params_for_version is not None:
        return params_from_numpy(params_for_version(version), device)
    gen = torch.Generator(device=device).manual_seed(int(version))
    return draw(gen)


def demo_mlp(d: int = 32, n_layers: int = 8, *, device="cuda",
             params_for_version: Callable[[int], Mapping[str, Any]] | None = None):
    """An *executable* demo model for the edge serving examples.

    Returns ``(graph, executor_for_version)``: a tanh-MLP layer graph plus a
    version -> ``ExecutorFn`` factory whose weights are keyed by the model
    version, so a ``VersionBumped`` redeploy visibly changes the served
    function.  Weights are ``N(0, 1) * 0.3`` drawn from
    ``torch.Generator(device).manual_seed(version)`` -- other numbers than
    the JAX package's ``jax.random`` draws -- unless ``params_for_version``
    (version -> ``{"ws": (n_layers, d, d)}``) supplies them.
    """
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.core.graph import chain
    from repro_torch.runtime.pipeline import make_layer_executor

    device = resolve_device(device)
    graph = chain(
        f"mlp{n_layers}", [(d * d * 4, 16 * d * 4)] * n_layers, in_bytes=16 * d * 4
    )

    def draw(gen):
        ws = torch.randn((n_layers, d, d), generator=gen, device=device) * 0.3
        return {"ws": ws}

    def executor_for_version(version: int):
        ws = _weights(params_for_version, version, device, draw)["ws"]
        return make_layer_executor(
            [lambda x, w=ws[i]: torch.tanh(x @ w) for i in range(n_layers)]
        )

    return graph, executor_for_version


def demo_ssm(d: int = 24, n_layers: int = 6, seq: int = 8, heads: int = 2,
             state: int = 4, *, device="cuda",
             params_for_version: Callable[[int], Mapping[str, Any]] | None = None):
    """An executable state-space demo model (Mamba2-style mixing layers).

    The multi-tenant deployments need a second model whose layer shapes
    differ from ``demo_mlp``'s: same ``(graph, executor_for_version)``
    contract, but each layer is a selective-state scan on
    ``kernels.ssm_scan``'s ``ssd_chunked`` (the CUDA kernel on a CUDA
    device): ``bm = x @ Wb``, ``cm = x @ Wc``, ``dt = softplus(x @ Wd)``,
    ``a = -0.5``, the chunked SSD recurrence at ``chunk=seq``, and
    ``tanh(x + y)``.  Activations flow between layers as ``(seq, d)``
    float32, so ``out_bytes = seq * d * 4``, and per-layer params are the
    B/C/dt projections.  There is no fused codec handler (the JAX model has
    none): an int8 hop decodes through ``dequantize_int8``.

    Weights are ``N(0, 1) * 0.3`` drawn from
    ``torch.Generator(device).manual_seed(version)`` -- other numbers than
    the JAX package's ``jax.random`` draws -- unless ``params_for_version``
    (version -> ``{"wb", "wc", "wd"}`` stacked over layers) supplies them.
    """
    import torch

    from repro_torch.core.execution import resolve_device
    from repro_torch.core.graph import chain
    from repro_torch.kernels.ssm_scan import ssd_chunked
    from repro_torch.runtime.pipeline import make_layer_executor

    if d % heads != 0:
        raise ValueError(f"d={d} must be divisible by heads={heads}")
    device = resolve_device(device)
    dh = d // heads
    act_bytes = seq * d * ACT_BYTES
    # per-layer params: Wb/Wc (d x state each) + Wdt (d x heads) + a (heads)
    param_bytes = (2 * d * state + d * heads + heads) * 4
    graph = chain(
        f"ssm{n_layers}", [(param_bytes, act_bytes)] * n_layers,
        in_bytes=act_bytes,
    )

    def draw(gen):
        def normal(shape):
            return torch.randn(shape, generator=gen, device=device) * 0.3

        return {"wb": normal((n_layers, d, state)), "wc": normal((n_layers, d, state)),
                "wd": normal((n_layers, d, heads))}

    def executor_for_version(version: int):
        p = _weights(params_for_version, version, device, draw)
        wb, wc, wd = p["wb"], p["wc"], p["wd"]
        a = torch.full((heads,), -0.5, dtype=torch.float32, device=device)

        def layer(x, i):
            # batch-polymorphic: the serving engine stacks a microbatch onto
            # a leading axis; fold any leading dims into the scan's batch
            x = x.to(torch.float32)
            xb = x.reshape(-1, seq, d)
            n = xb.shape[0]
            xs = xb.reshape(n, seq, heads, dh)
            bm = xb @ wb[i]
            cm = xb @ wc[i]
            z = xb @ wd[i]
            dt = torch.logaddexp(z, torch.zeros_like(z))  # jax.nn.softplus's form
            y = ssd_chunked(xs, bm, cm, dt, a, chunk=seq)
            return torch.tanh(xb + y.reshape(n, seq, d)).reshape(x.shape)

        return make_layer_executor(
            [lambda x, i=i: layer(x, i) for i in range(n_layers)]
        )

    return graph, executor_for_version


def demo_transformer(d: int = 32, n_layers: int = 4, seq: int = 256,
                     heads: int = 4, kv_heads: int = 2, mlp_mult: int = 2,
                     window: int = 128, softcap: float = 50.0,
                     attn_block: int = 128, *, device="cuda",
                     params_for_version: Callable[[int], Mapping[str, Any]] | None = None):
    """An executable transformer demo model on the flash-attention kernel.

    Architecture knobs are scaled-down gemma2-27b: GQA at ratio 2
    (``heads=4, kv_heads=2`` mirroring 32/16), logit softcap 50.0, and
    gemma2's local/global alternation -- odd layers attend through a
    sliding window, even layers globally.  Every layer's attention runs
    ``kernels.flash_attention`` (the CUDA kernel on a CUDA device).
    ``attn_block`` is the JAX package's attention tile; it is kept so the
    two constructors take the same arguments, and the CUDA kernel tiles by
    its own 64.

    Each layer's FIRST op is ``x @ Wqkv`` and nothing else reads ``x``, so
    when the inbound link codec is int8 the layer's fused handler (the
    ``fused`` attribute consumed by ``make_layer_executor``) feeds the wire
    payload straight into ``kernels.quantize.dequant_matmul`` -- the
    dequantized activation is never materialized.  Activations are
    ``(seq, d)`` float32 between layers.

    Weights are ``N(0, 1) * 0.3`` drawn from
    ``torch.Generator(device).manual_seed(version)`` -- other numbers than
    the JAX package's ``jax.random`` draws -- unless ``params_for_version``
    (version -> ``{"wqkv", "wo", "w1", "w2"}`` stacked over layers)
    supplies them.  The MLP's GELU is the tanh approximation, which is what
    ``jax.nn.gelu`` computes by default.

    The f32 products ``x @ Wqkv``, ``o @ Wo``, ``y @ W1`` and ``gelu(.) @
    W2`` go through ``kernels.gemm.matmul_f32``: on a CUDA device the
    split-TF32 GEMM, which reads each weight as its TF32 planes, split once
    per version here; on the CPU ``x @ w``.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.core.execution import resolve_device
    from repro_torch.core.graph import chain
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.kernels.quantize import dequant_matmul
    from repro_torch.runtime.pipeline import make_layer_executor

    if d % heads or heads % kv_heads:
        raise ValueError(f"need d % heads == 0 and heads % kv_heads == 0, "
                         f"got d={d}, heads={heads}, kv_heads={kv_heads}")
    device = resolve_device(device)
    hd = d // heads
    proj = (heads + 2 * kv_heads) * hd  # fused q|k|v projection width
    f = mlp_mult * d
    act_bytes = seq * d * ACT_BYTES
    param_bytes = (d * proj + d * d + 2 * d * f) * 4
    graph = chain(
        f"transformer{n_layers}", [(param_bytes, act_bytes)] * n_layers,
        in_bytes=act_bytes,
    )

    def draw(gen):
        def normal(shape):
            return torch.randn(shape, generator=gen, device=device) * 0.3

        return {"wqkv": normal((n_layers, d, proj)), "wo": normal((n_layers, d, d)),
                "w1": normal((n_layers, d, f)), "w2": normal((n_layers, f, d))}

    def executor_for_version(version: int):
        p = _weights(params_for_version, version, device, draw)
        wqkv = p["wqkv"]
        # what the f32 GEMM reads in place of each layer's weight (None on the CPU)
        planes = {name: [gemm_ops.weight_planes(w) for w in p[name]]
                  for name in ("wqkv", "wo", "w1", "w2")}

        def mm(x, name, i):
            return gemm_ops.matmul_f32(x, p[name][i], planes[name][i])

        def tail(qkv, out_shape, i, win):
            # everything after the qkv projection: attention + out-proj +
            # gelu MLP, residual around the MLP, tanh to keep depth stable.
            # q/k/v stay strided views of qkv: the kernel reads them in place
            qkvb = qkv.to(torch.float32).reshape(-1, seq, proj)
            n = qkvb.shape[0]
            qh = qkvb[..., : heads * hd].reshape(n, seq, heads, hd)
            kk = qkvb[..., heads * hd: (heads + kv_heads) * hd]
            vv = qkvb[..., (heads + kv_heads) * hd:]
            o = flash_attention(
                qh,
                kk.reshape(n, seq, kv_heads, hd),
                vv.reshape(n, seq, kv_heads, hd),
                causal=True, window=win, softcap=softcap,
            )
            y = mm(o.reshape(n, seq, d), "wo", i)
            z = y + mm(F.gelu(mm(y, "w1", i), approximate="tanh"), "w2", i)
            return torch.tanh(z).reshape(out_shape)

        def make_layer(i):
            # gemma2-style alternation: odd layers local (sliding window)
            win = window if (window > 0 and i % 2 == 1) else 0

            def layer_fn(x):
                x = x.to(torch.float32)
                qkv = mm(x.reshape(-1, seq, d), "wqkv", i)
                return tail(qkv, x.shape, i, win)

            def fused_int8(enc):
                # enc: dataplane EncodedActivation with an Int8Codec payload
                if enc.payload[0] != "torch":
                    return layer_fn(enc.decode())
                _, q, s, _dtype = enc.payload
                qkv = dequant_matmul(q, s, wqkv[i], dtype=torch.float32,
                                     block=enc.codec.block)
                return tail(qkv, q.shape, i, win)

            layer_fn.fused = {"int8": fused_int8}
            return layer_fn

        return make_layer_executor([make_layer(i) for i in range(n_layers)])

    return graph, executor_for_version


def _zamba2_shapes(d: int, d_in: int, mamba_heads: int, groups: int, state: int, conv: int,
                   attn_heads: int, attn_head_dim: int, ffn: int, adapter_rank: int):
    """Name -> one copy's shape of ``zamba2_hybrid``'s weights, in three
    kinds: a Mamba2 layer's, a shared block's and a hybrid layer's own."""
    conv_dim = d_in + 2 * groups * state
    ad = attn_heads * attn_head_dim
    mamba = {"in_norm": (d,), "in_proj": (d, d_in + conv_dim + mamba_heads),
             "conv_w": (conv, conv_dim), "conv_b": (conv_dim,), "dt_bias": (mamba_heads,),
             "A_log": (mamba_heads,), "D": (mamba_heads,), "norm_w": (d_in,),
             "out_proj": (d_in, d)}
    block = {"attn_norm": (2 * d,), "wqkv": (2 * d, 3 * ad), "wo": (ad, d), "ffn_norm": (d,),
             "w_gu": (d, 2 * ffn), "w_down": (ffn, d)}
    hybrid = {"adapter_a": (d, adapter_rank), "adapter_b": (adapter_rank, 2 * ffn),
              "w_lin": (d, d)}
    return mamba, block, hybrid


def zamba2_hybrid(d: int = 64, d_in: int = 128, mamba_heads: int = 8, groups: int = 2,
                  state: int = 16, conv: int = 4, attn_heads: int = 2, attn_head_dim: int = 64,
                  ffn: int = 128, adapter_rank: int = 8,
                  layer_types: tuple[str, ...] = ("hybrid", "mamba", "mamba"),
                  seq: int = 64, *, mem_blocks: int = 2, hybrid_offset: int = 0,
                  chunk: int = 256, rope_theta: float = 10000.0, eps: float = 1e-5,
                  device="cuda",
                  params_for_version: Callable[[int], Mapping[str, Any]] | None = None):
    """Zamba2's layers as an executable model (Zamba2-7B: d 3584, d_in 7168,
    112 Mamba2 heads of 64 in 2 B / C groups, state 64, conv 4; 32 attention
    heads of 224 over the 7168-wide concatenation, a gated GELU MLP of 14336,
    rank-128 adapters), with Hugging Face transformers' ``modeling_zamba2``
    layer equations.

    ``layer_types`` gives each layer's kind: ``"mamba"`` (a Mamba2 layer) or
    ``"hybrid"`` (a shared transformer block, then a Mamba2 layer).  The
    ``mem_blocks`` shared blocks are used in turn: the model's k-th hybrid
    layer takes block k mod ``mem_blocks``, and ``hybrid_offset`` counts the
    hybrid layers that precede the first one here.  Each hybrid layer has its
    own MLP adapter and output linear.  With h the residual stream and x0
    the embedding output:

    - shared block: c = RMSNorm([h | x0]); q, k, v = c W_qkv (rotary over
      all ``attn_head_dim`` dims, theta ``rope_theta``, angles in f64); causal attention
      scaled by (hd / 2)^-0.5; m = RMSNorm(o W_o); [gate | up] = m W_gu +
      (m A_l) B_l; t = ((gelu_erf(gate) up) W_down) W_lin,l;
    - Mamba2 layer: a = RMSNorm(h + t) (t = 0 on a Mamba2-only layer);
      [z | xBC | dt] = a W_in; xBC = silu(conv(xBC) + b); [x | B | C];
      dt = softplus(dt + dt_bias); A = -exp(A_log); y = SSD scan (head j
      reading B / C group j // (heads / groups)) + D x; out = h + RMSNorm_G(y
      silu(z)) W_out, the residual taken before t is added.

    Every norm is RMSNorm at ``eps`` with a weight; no product has a bias.
    The activation between layers and stages is one (seq, 2 d) tensor [h |
    x0]: every hybrid layer reads x0, which passes through unchanged.  Every
    product runs ``kernels.gemm.matmul_f32`` (weight planes split once a
    version), the scan ``ssd_chunked`` with grouped B and C, attention
    ``flash_attention`` at the given scale.  There is no fused int8 receive
    (every layer starts with a norm): an int8 hop decodes through
    ``dequantize_int8``.

    Weights are held once a version: a shared block's tensors are the same
    objects in every hybrid layer that uses it, and each layer fn carries
    them as ``.block`` (the executor's ``.layer_fns``; ``.params`` holds the
    version's weights).  The layer graph
    counts a block's bytes on every hybrid layer that uses it, since the
    planner may place those layers on different nodes.  ``params_for_version``
    (version -> flat arrays: each Mamba2 weight stacked over the layers, each
    block weight over the ``mem_blocks`` blocks, each adapter and linear over
    the hybrid layers, in order; ``_zamba2_shapes`` names them) supplies the
    weights; else they are drawn from ``torch.Generator(device)`` seeded by
    the version.  The executor counts each block's calls in
    ``.shared_calls``.  Regions: ``seifer.zamba2.mixer`` (a Mamba2 layer),
    ``seifer.zamba2.scan`` (its scan) and ``seifer.zamba2.shared`` (a shared
    block with its adapter and linear).
    """
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.core.execution import resolve_device
    from repro_torch.core.graph import chain
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.kernels.ssm_scan import ssd_chunked
    from repro_torch.models.common import silu, softplus
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.ssm import causal_conv, gated_rmsnorm, split_xbc
    from repro_torch.obs.trace import region
    from repro_torch.runtime.pipeline import make_layer_executor

    if any(t not in ("mamba", "hybrid") for t in layer_types):
        raise ValueError(f"layer_types holds 'mamba' or 'hybrid', got {layer_types}")
    if d_in % mamba_heads or mamba_heads % groups or d_in % groups:
        raise ValueError(f"need d_in % mamba_heads == 0 and mamba_heads % groups == 0, got "
                         f"d_in={d_in}, mamba_heads={mamba_heads}, groups={groups}")
    if attn_head_dim % 2:
        raise ValueError(f"rotary needs an even head dim, got {attn_head_dim}")
    device = resolve_device(device)
    n_layers = len(layer_types)
    hybrids = [i for i, t in enumerate(layer_types) if t == "hybrid"]
    block_of = {i: (hybrid_offset + k) % mem_blocks for k, i in enumerate(hybrids)}
    p_head = d_in // mamba_heads
    conv_dim = d_in + 2 * groups * state
    ad = attn_heads * attn_head_dim
    mamba_s, block_s, hybrid_s = _zamba2_shapes(d, d_in, mamba_heads, groups, state, conv,
                                                attn_heads, attn_head_dim, ffn, adapter_rank)

    def nbytes(shapes):
        return 4 * sum(math.prod(s) for s in shapes.values())

    act_bytes = seq * 2 * d * ACT_BYTES
    layer_bytes = [nbytes(mamba_s) + (nbytes(block_s) + nbytes(hybrid_s) if i in block_of else 0)
                   for i in range(n_layers)]
    graph = chain(f"zamba2_{n_layers}", [(b, act_bytes) for b in layer_bytes],
                  in_bytes=act_bytes)
    stacked = ([(k, n_layers, s) for k, s in mamba_s.items()]
               + [(k, mem_blocks, s) for k, s in block_s.items()]
               + [(k, len(hybrids), s) for k, s in hybrid_s.items()])

    def draw(gen):
        def normal(lead, shape, fan_in):
            return torch.randn((lead, *shape), generator=gen, device=device) * fan_in**-0.5

        def uniform(lead, shape, lo, hi):
            return torch.rand((lead, *shape), generator=gen, device=device) * (hi - lo) + lo

        out = {}
        for name, lead, shape in stacked:
            if name.endswith("norm") or name.endswith("norm_w") or name == "D":
                out[name] = torch.ones((lead, *shape), device=device)
            elif name == "A_log":
                out[name] = torch.log(uniform(lead, shape, 1.0, 16.0))
            elif name == "dt_bias":  # softplus^-1 of dt, log-uniform on [1e-3, 0.1]
                dt = torch.exp(uniform(lead, shape, math.log(1e-3), math.log(0.1)))
                out[name] = dt + torch.log(-torch.expm1(-dt))
            else:
                out[name] = normal(lead, shape, conv if name.startswith("conv") else shape[0])
        return out

    # rotate-half tables; the angles (up to S radians) in f64, rounded once
    freq = rope_theta ** (-torch.arange(0, attn_head_dim, 2, dtype=torch.float64,
                                        device=device) / attn_head_dim)
    angles = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * freq[None]
    angles = torch.cat([angles, angles], -1)
    cos = angles.cos().float()[:, None, :]  # (S, 1, hd)
    sin = angles.sin().float()[:, None, :]
    half = attn_head_dim // 2

    def rotary(x):
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rot * sin

    def executor_for_version(version: int):
        p = _weights(params_for_version, version, device, draw)
        planes = {name: [gemm_ops.weight_planes(w) for w in p[name]]
                  for name in ("in_proj", "out_proj", "wqkv", "wo", "w_gu", "w_down",
                               "adapter_a", "adapter_b", "w_lin")}
        blocks = [{name: (p[name][j], planes.get(name, [None] * mem_blocks)[j])
                   for name in block_s} for j in range(mem_blocks)]
        shared_calls = [0] * mem_blocks

        def mm(x, pair):
            return gemm_ops.matmul_f32(x, *pair)

        def own(name, i):
            return p[name][i], planes[name][i]

        def shared(hx, j, k):
            """t of hybrid layer k (block j) over [h | x0] (n, S, 2d)."""
            blk = blocks[j]
            n = hx.shape[0]
            c = rmsnorm(hx, blk["attn_norm"][0], eps=eps)
            qkv = mm(c, blk["wqkv"]).view(n, seq, 3, attn_heads, attn_head_dim)
            o = flash_attention(rotary(qkv[:, :, 0]), rotary(qkv[:, :, 1]), qkv[:, :, 2],
                                causal=True, scale=(attn_head_dim / 2) ** -0.5)
            m = rmsnorm(mm(o.reshape(n, seq, ad), blk["wo"]), blk["ffn_norm"][0], eps=eps)
            gu = mm(m, blk["w_gu"]) + mm(mm(m, own("adapter_a", k)), own("adapter_b", k))
            f = mm(F.gelu(gu[..., :ffn]) * gu[..., ffn:], blk["w_down"])
            shared_calls[j] += 1
            return mm(f, own("w_lin", k))

        def mixer(h, t, i):
            """The Mamba2 layer i over h (n, S, d), its input h + t."""
            n = h.shape[0]
            u = h if t is None else h + t
            zxbcdt = mm(rmsnorm(u, p["in_norm"][i], eps=eps), own("in_proj", i))
            z = zxbcdt[..., :d_in]
            xbc = silu(causal_conv(zxbcdt[..., d_in:d_in + conv_dim], p["conv_w"][i],
                                   p["conv_b"][i]))
            dt = softplus(zxbcdt[..., d_in + conv_dim:] + p["dt_bias"][i])
            x, bm, cm = split_xbc(xbc, d_in, state, groups)
            xs = x.reshape(n, seq, mamba_heads, p_head).contiguous()
            with region("seifer.zamba2.scan"):
                y = ssd_chunked(xs, bm, cm, dt.contiguous(), -torch.exp(p["A_log"][i]),
                                chunk=chunk)
            y = y + xs * p["D"][i][None, None, :, None]
            g = gated_rmsnorm(y.reshape(n, seq, d_in), z, p["norm_w"][i], n_groups=groups,
                              eps=eps)
            return h + mm(g, own("out_proj", i))

        def make_layer(i):
            j = block_of.get(i)
            k = hybrids.index(i) if j is not None else None

            def layer_fn(x):
                hx = x.to(torch.float32).reshape(-1, seq, 2 * d)
                t = None
                if j is not None:
                    with region("seifer.zamba2.shared"):
                        t = shared(hx, j, k)
                with region("seifer.zamba2.mixer"):
                    h = mixer(hx[..., :d], t, i)
                return torch.cat([h, hx[..., d:]], -1).reshape(x.shape)

            layer_fn.block = None if j is None else blocks[j]
            return layer_fn

        layer_fns = [make_layer(i) for i in range(n_layers)]
        executor = make_layer_executor(layer_fns)
        executor.layer_fns = layer_fns
        executor.params = p
        executor.shared_calls = shared_calls
        return executor

    return graph, executor_for_version
