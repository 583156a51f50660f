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
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.core.execution import resolve_device
    from repro_torch.core.graph import chain
    from repro_torch.kernels.flash_attention import flash_attention
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
        wqkv, wo, w1, w2 = p["wqkv"], p["wo"], p["w1"], p["w2"]

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
            y = o.reshape(n, seq, d) @ wo[i]
            z = y + F.gelu(y @ w1[i], approximate="tanh") @ w2[i]
            return torch.tanh(z).reshape(out_shape)

        def make_layer(i):
            # gemma2-style alternation: odd layers local (sliding window)
            win = window if (window > 0 and i % 2 == 1) else 0

            def layer_fn(x):
                x = x.to(torch.float32)
                qkv = x.reshape(-1, seq, d) @ wqkv[i]
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
