"""Weight-only int8 quantization for the decode path.

Decode at serving batch sizes is weights-bandwidth-bound (the 1B layer stack
is ~1.95 GB of the ~2.5 GB of weights read per decode step). Per-output-channel
symmetric int8 storage halves that traffic. On an H100, XLA compiles the matmul
into its own Triton GEMM fusion with the int8->bf16 convert nested in the
operand load (compiled HLO: a ``block_fusion`` inside a
``__triton_nested_gemm_fusion``), so no bf16 copy of the weights is written and
cuBLAS never sees this matmul; compute stays bf16, no activation quantization.

Scope: the stacked layer matmuls (wq/wk/wv/wo/w_gate/w_up/w_down). The tied
embedding stays bf16 — it feeds both the token gather and the final logits
matmul, where per-channel (=per-vocab-row) scales would need an extra [V]
multiply on the logits hot path, and quality is most sensitive there. Norms
are tiny and stay bf16.

Quality: greedy outputs are NOT bitwise vs bf16 (quantization error flips
argmax near ties). Opt-in via ``quantize_weights: int8`` in the generation
config; the reference has no quantized path at all (vLLM's fp8/awq analog).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["quantize_layer_weights_int8", "matmul"]

_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_one(w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One layer [in, out] -> (int8 [in, out], bf16 scale [1, out])."""
    amax = jnp.max(jnp.abs(w.astype(jnp.float32)), axis=0, keepdims=True)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(w.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.bfloat16)


@jax.jit
def _quantize(w: jnp.ndarray) -> dict[str, jnp.ndarray]:
    """Per-output-channel symmetric int8: w [L, in, out] -> int8 + bf16 scale.

    lax.map over the stacked layer axis bounds the f32 upcast transients to one
    layer (~100 MB at 3B) instead of the whole stack (~2.8 GB) — quantizing 3B+
    checkpoints must not OOM the chip that is about to serve them. Per-layer
    math is unchanged, so quantized values are bit-identical to the fused form.
    """
    q, scale = lax.map(_quantize_one, w)
    return {"q": q, "scale": scale}


def quantize_layer_weights_int8(params: Any) -> Any:
    """Return a params pytree with the stacked layer matmuls in int8 form.

    The quantized leaves become ``{"q": int8 [L, in, out], "scale": bf16
    [L, 1, out]}``; everything else (embed, norms) is unchanged. ``matmul``
    dispatches on the leaf type, so no marker is needed — the same decode
    graph serves both forms (a different compiled program per form).
    """
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        layers[name] = _quantize(params["layers"][name])
    out["layers"] = layers
    return out


def matmul(x: jnp.ndarray, w: Any) -> jnp.ndarray:
    """x @ w for either a plain array or an int8 {"q", "scale"} leaf.

    The int8 path computes ``(x @ q.astype(x.dtype)) * scale`` — XLA fuses the
    convert into the GEMM's weight load, so only int8 weight bytes are read.
    """
    if isinstance(w, dict):
        return (x @ w["q"].astype(x.dtype)) * w["scale"].astype(x.dtype)
    return x @ w
