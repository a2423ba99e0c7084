"""Causal multi-head attention (GQA) for training.

Replaces the reference's reliance on torch SDPA/flex-attention inside torchtune
(ref: SURVEY.md §2.3 — torchtune model kernels). Two interchangeable backends:

- ``xla``: straightforward einsum attention with fp32 softmax — the plain
  reference and the CPU path.
- ``cudnn``: ``jax.nn.dot_product_attention(implementation="cudnn")``, cuDNN's
  fused flash attention (forward and backward) on NVIDIA GPUs, with native GQA
  and ``is_causal``; packed rows pass their segment mask through ``mask``.

Both compute the same math: causal masking, GQA key/value head sharing, softmax
in fp32, output in the input dtype. ``"auto"`` resolves by platform and dtype
(:func:`resolve_attn_impl`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_NEG_INF = -2.0e38


def _repeat_kv(x: jnp.ndarray, n_rep: int) -> jnp.ndarray:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return jnp.broadcast_to(x[:, :, :, None, :], (b, s, h, n_rep, d)).reshape(b, s, h * n_rep, d)


def xla_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    causal: bool = True,
    segment_ids: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reference attention in pure XLA.

    Args:
        q: ``[B, S, Hq, D]``.
        k, v: ``[B, S, Hkv, D]`` with ``Hq % Hkv == 0``.
        segment_ids: optional ``[B, S]`` int array; attention is restricted to equal
            segments (packed-sequence support). ``0`` may be used for padding.

    Returns:
        ``[B, S, Hq, D]`` in q's dtype.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)

    scale = 1.0 / (d**0.5)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32) * scale

    mask = None
    if causal:
        q_pos = jax.lax.broadcasted_iota(jnp.int32, (s, s), 0)
        k_pos = jax.lax.broadcasted_iota(jnp.int32, (s, s), 1)
        mask = k_pos <= q_pos  # [S, S]
        mask = mask[None, None, :, :]
    if segment_ids is not None:
        seg_mask = segment_mask(segment_ids)
        mask = seg_mask if mask is None else jnp.logical_and(mask, seg_mask)
    if mask is not None:
        logits = jnp.where(mask, logits, _NEG_INF)

    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", probs.astype(v.dtype), v)
    return out.astype(q.dtype)


def segment_mask(segment_ids: jnp.ndarray) -> jnp.ndarray:
    """``[B, S]`` segment ids -> ``[B, 1, S, S]`` bool mask (query and key in one segment)."""
    return (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, :, :]


def cudnn_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    causal: bool = True,
    segment_ids: jnp.ndarray | None = None,
    implementation: str = "cudnn",
) -> jnp.ndarray:
    """Attention through ``jax.nn.dot_product_attention`` (cuDNN fused flash attention).

    Same contract as :func:`xla_attention`: q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]``
    (GQA is native), optional ``[B, S]`` segment ids. cuDNN takes bf16/fp16 only.
    ``implementation`` exists so the CPU tests can drive the same argument
    construction through JAX's own XLA implementation (``"xla"``).
    """
    mask = None if segment_ids is None else segment_mask(segment_ids)
    out = jax.nn.dot_product_attention(q, k, v, mask=mask, is_causal=causal, implementation=implementation)
    return out.astype(q.dtype)


ATTN_IMPLS = ("xla", "cudnn")
# "auto" per platform: cuDNN's fused attention on the GPU, the einsum reference on the CPU
_AUTO_ATTN = {"gpu": "cudnn", "cpu": "xla"}
_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)


def resolve_attn_impl(impl: str, dtype, platform: str | None = None) -> str:
    """Name the attention backend that runs for inputs of ``dtype``.

    ``"auto"`` resolves by the platform of the first device (or ``platform``) and
    by the dtype: cuDNN takes bf16/fp16 only, so float32 runs the einsum path on
    every platform. Unknown names and platforms raise.
    """
    if impl == "auto":
        platform = platform or jax.devices()[0].platform
        if platform not in _AUTO_ATTN:
            raise ValueError(f"No attention implementation for platform {platform!r}")
        impl = _AUTO_ATTN[platform]
        return impl if impl != "cudnn" or jnp.dtype(dtype) in _CUDNN_DTYPES else "xla"
    if impl not in ATTN_IMPLS:
        raise ValueError(f"Unknown attention impl: {impl!r}; expected one of {ATTN_IMPLS} or 'auto'")
    return impl


def dispatch_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    causal: bool = True,
    segment_ids: jnp.ndarray | None = None,
    impl: str = "auto",
) -> jnp.ndarray:
    """Resolve and run the attention backend (shared by the model and the jitted API)."""
    impl = resolve_attn_impl(impl, q.dtype)
    if impl == "cudnn":
        return cudnn_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)


@functools.partial(jax.jit, static_argnames=("causal", "impl"))
def attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    *,
    causal: bool = True,
    segment_ids: jnp.ndarray | None = None,
    impl: str = "auto",
) -> jnp.ndarray:
    """Jitted entry point over :func:`dispatch_attention`."""
    return dispatch_attention(q, k, v, causal=causal, segment_ids=segment_ids, impl=impl)
