"""Functional JAX implementation of the Llama 3.2 decoder (tied embeddings).

A JAX-first design, not a torchtune port (ref architecture: SURVEY.md §2.1 "Model
factory"/"Model config", ssi/model.py:18-39, ssi/llama_configs.py:127-140):

- Parameters are a plain pytree with **layer-stacked** weights; the decoder runs as a
  single ``lax.scan`` over layers → one compiled block regardless of depth.
- Weights are kept in the HF rotate-half RoPE convention so HF checkpoints load and
  save without the q/k permutations torchtune needs.
- Linear weights are stored ``[in, out]`` so the forward pass is plain ``x @ W``.
- ``forward`` returns final-norm hidden states; the tied logits projection lives in
  the fused cross-entropy op (training) or ``logits()`` (inference), so training
  never materializes the full-vocab logits tensor.
- Optional ``jax.checkpoint`` rematerialization per layer for HBM savings.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from jax.ad_checkpoint import checkpoint_name

from ssi_jax.models.configs import ConfigLlama3_2
from ssi_jax.models.rope import apply_rope, rope_cos_sin
from ssi_jax.ops.attention import xla_attention

Params = dict[str, Any]

# Rematerialization policies for the backward pass. "full" recomputes the whole
# block (max HBM savings, bwd ~= 3.4x fwd); the "save_*" policies keep the named
# matmul outputs resident so the backward pass skips recomputing them — at
# bs4xS768 the QKV+gate+up set costs ~119 MB/layer and avoids ~64% of the
# recompute FLOPs (the MLP matmuls dominate: 824 of 1532 GFLOP/layer/micro).
REMAT_POLICIES = ("full", "none", "save_qkv", "save_mlp", "save_qkv_mlp", "save_qkv_mlp_attn")


def _remat_policy(remat: bool | str):
    """Map a remat spec to (apply_checkpoint, policy). bool is legacy full/none."""
    if isinstance(remat, bool):
        remat = "full" if remat else "none"
    if remat == "none":
        return False, None
    if remat == "full":
        return True, None  # default policy: save only block inputs
    saveable = {
        "save_qkv": ("qkv",),
        "save_mlp": ("mlp_gate", "mlp_up"),
        "save_qkv_mlp": ("qkv", "mlp_gate", "mlp_up"),
        # + the attention output: the flash custom-VJP's residuals (o, lse)
        # otherwise force a full forward-kernel re-run in the backward pass
        # (round-3 profile: 113 ms/step of rematted_computation) for ~13
        # MB/layer extra residency.
        "save_qkv_mlp_attn": ("qkv", "mlp_gate", "mlp_up", "attn_out"),
    }
    if remat not in saveable:
        raise ValueError(f"Unknown remat policy {remat!r}; expected one of {REMAT_POLICIES} or bool")
    return True, jax.checkpoint_policies.save_only_these_names(*saveable[remat])


def rms_norm(x: jnp.ndarray, weight: jnp.ndarray, eps: float) -> jnp.ndarray:
    x32 = x.astype(jnp.float32)
    normed = x32 * jax.lax.rsqrt(jnp.mean(x32 * x32, axis=-1, keepdims=True) + eps)
    return (normed * weight.astype(jnp.float32)).astype(x.dtype)


def _block(
    h: jnp.ndarray,
    layer: Params,
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    cfg: ConfigLlama3_2,
    attn_impl: str,
    segment_ids: jnp.ndarray | None,
) -> jnp.ndarray:
    b, s, d = h.shape
    hd = cfg.head_dim

    x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    q = (x @ layer["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ layer["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ layer["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    # Post-RoPE Q/K/V tagged for selective remat: saving them (~19 MB/layer at
    # bs4xS768) lets the backward pass skip the three projection matmuls and the
    # norm recompute on the attention path.
    q = checkpoint_name(apply_rope(q, cos, sin), "qkv")
    k = checkpoint_name(apply_rope(k, cos, sin), "qkv")
    v = checkpoint_name(v, "qkv")
    from ssi_jax.ops.attention import dispatch_attention

    attn = dispatch_attention(q, k, v, causal=True, segment_ids=segment_ids, impl=attn_impl)
    h = h + attn.reshape(b, s, cfg.num_heads * hd) @ layer["wo"]

    x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
    # Tag the PRE-activation matmul outputs (not silu(gate) / the product): the
    # nonlinearity and elementwise product are cheap to recompute, the [*, 8192]
    # matmuls are the 54% of block FLOPs worth never re-running.
    gate_pre = checkpoint_name(x @ layer["w_gate"], "mlp_gate")
    up = checkpoint_name(x @ layer["w_up"], "mlp_up")
    h = h + (jax.nn.silu(gate_pre) * up) @ layer["w_down"]
    return h


def forward(
    params: Params,
    tokens: jnp.ndarray,
    cfg: ConfigLlama3_2,
    *,
    positions: jnp.ndarray | None = None,
    segment_ids: jnp.ndarray | None = None,
    attn_impl: str = "xla",
    remat: bool | str = True,
) -> jnp.ndarray:
    """Run the decoder; returns final-normed hidden states ``[B, S, D]``.

    Args:
        params: pytree from :func:`init_params` / checkpoint load.
        tokens: ``[B, S]`` int32 token IDs.
        positions: optional ``[B, S]`` positions (defaults to 0..S-1 per row).
        segment_ids: optional ``[B, S]`` for packed sequences.
        remat: bool (legacy full/none) or a policy name from REMAT_POLICIES.
    """
    b, s = tokens.shape
    h = params["embed"][tokens]  # gather; [B, S, D]
    if positions is None:
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :], (b, s))
    cos, sin = rope_cos_sin(
        positions,
        cfg.head_dim,
        rope_base=cfg.rope_base,
        scale_factor=cfg.scale_factor,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_seq_len=cfg.rope_original_max_seq_len,
    )

    block = functools.partial(_block, cos=cos, sin=sin, cfg=cfg, attn_impl=attn_impl, segment_ids=segment_ids)
    do_ckpt, policy = _remat_policy(remat)
    if do_ckpt:
        block = jax.checkpoint(block, prevent_cse=False, policy=policy)

    def scan_body(h, layer):
        return block(h, layer), None

    h, _ = jax.lax.scan(scan_body, h, params["layers"])
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def unembed(params: Params) -> jnp.ndarray:
    """The output-projection matrix ``[V, D]``: the tied embedding (Llama 3.2
    1B/3B) or the separate ``lm_head`` when the checkpoint ships one (Llama 3.1
    8B, ``tied_embeddings=False``)."""
    return params.get("lm_head", params["embed"])


def logits(params: Params, hidden: jnp.ndarray) -> jnp.ndarray:
    """Output projection (fp32 logits); tied or untied per the param tree."""
    return jnp.dot(hidden, unembed(params).T, preferred_element_type=jnp.float32)


# ----------------------------------------------------------------------------------
# KV-cache decode path (single-token steps for generation)
# ----------------------------------------------------------------------------------


DECODE_NEG_INF = -1.0e30


def init_kv_cache(cfg: ConfigLlama3_2, batch: int, max_len: int, dtype=jnp.bfloat16) -> Params:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}


def decode_block(params_layer, h, cos, sin, cache_k, cache_v, slot_ids, attn_mask, cfg):
    """One decoder layer over T new tokens, writing K/V into cache slots.

    h: [B, T, D]; cache_k/v: [B, M, Hkv, hd]; slot_ids: [T] absolute cache slots;
    attn_mask: [B, T, M] bool (True = attend).
    """
    b, t, d = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, params_layer["attn_norm"], cfg.norm_eps)
    q = (x @ params_layer["wq"]).reshape(b, t, cfg.num_heads, hd)
    k = (x @ params_layer["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = (x @ params_layer["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    cache_k = jax.lax.dynamic_update_slice_in_dim(cache_k, k.astype(cache_k.dtype), slot_ids[0], axis=1)
    cache_v = jax.lax.dynamic_update_slice_in_dim(cache_v, v.astype(cache_v.dtype), slot_ids[0], axis=1)

    # Grouped-query attention without materializing repeated K/V: the repeat would
    # multiply per-step cache reads by Hq/Hkv (4x for Llama 3.2) — decode is
    # bandwidth-bound, so read the cache once and group q heads instead.
    n_rep = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, t, cfg.num_kv_heads, n_rep, hd)
    scale = 1.0 / (hd**0.5)
    logits = jnp.einsum("btkgd,bmkd->bkgtm", qg, cache_k.astype(q.dtype), preferred_element_type=jnp.float32) * scale
    logits = jnp.where(attn_mask[:, None, None, :, :], logits, DECODE_NEG_INF)
    probs = jax.nn.softmax(logits, axis=-1)
    attn = jnp.einsum("bkgtm,bmkd->btkgd", probs.astype(cache_v.dtype), cache_v)
    h = h + attn.reshape(b, t, cfg.num_heads * hd).astype(h.dtype) @ params_layer["wo"]

    x = rms_norm(h, params_layer["mlp_norm"], cfg.norm_eps)
    gate = jax.nn.silu(x @ params_layer["w_gate"])
    up = x @ params_layer["w_up"]
    h = h + (gate * up) @ params_layer["w_down"]
    return h, cache_k, cache_v


def forward_slots(params, tokens, cfg, cache, slot_start, pad_offsets, t_len):
    """Decoder forward for tokens occupying cache slots [slot_start, slot_start+T).

    The canonical KV-cache decode path (used by the generation engine and the
    parity tests). ``pad_offsets``: [B] left-pad slots per row — masked out of
    attention and subtracted from RoPE positions.

    Returns (final-norm hidden [B, T, D], updated cache).
    """
    b = tokens.shape[0]
    m = cache["k"].shape[2]
    slot_ids = slot_start + jnp.arange(t_len, dtype=jnp.int32)  # [T]
    # RoPE positions are pad-relative; clamp at 0 for pad slots (masked anyway).
    positions = jnp.maximum(slot_ids[None, :] - pad_offsets[:, None], 0)  # [B, T]
    cos, sin = rope_cos_sin(
        positions,
        cfg.head_dim,
        rope_base=cfg.rope_base,
        scale_factor=cfg.scale_factor,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_seq_len=cfg.rope_original_max_seq_len,
    )

    kv_slots = jnp.arange(m, dtype=jnp.int32)  # [M]
    causal = kv_slots[None, None, :] <= slot_ids[None, :, None]  # [1, T, M]
    valid = kv_slots[None, None, :] >= pad_offsets[:, None, None]  # [B, 1, M]
    attn_mask = jnp.logical_and(causal, valid)  # [B, T, M]

    h = params["embed"][tokens]

    def body(carry, xs):
        h = carry
        layer, ck, cv = xs
        h, ck, cv = decode_block(layer, h, cos, sin, ck, cv, slot_ids, attn_mask, cfg)
        return h, (ck, cv)

    h, (new_k, new_v) = jax.lax.scan(body, h, (params["layers"], cache["k"], cache["v"]))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, {"k": new_k, "v": new_v}


# ----------------------------------------------------------------------------------
# Initialization (tests / from-scratch experiments)
# ----------------------------------------------------------------------------------


def init_params(cfg: ConfigLlama3_2, key: jax.Array, dtype=jnp.bfloat16) -> Params:
    """Random small-normal initialization (tests use this; training loads checkpoints)."""
    d, f, hd = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    hq, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size
    keys = jax.random.split(key, 9)

    def norm_init(k, shape, fan_in):
        return (jax.random.normal(k, shape, jnp.float32) * (fan_in**-0.5)).astype(dtype)

    extra = {} if cfg.tied_embeddings else {"lm_head": norm_init(keys[8], (v, d), d)}
    return extra | {
        "embed": norm_init(keys[0], (v, d), d),
        "layers": {
            "attn_norm": jnp.ones((nl, d), dtype),
            "wq": norm_init(keys[1], (nl, d, hq * hd), d),
            "wk": norm_init(keys[2], (nl, d, hkv * hd), d),
            "wv": norm_init(keys[3], (nl, d, hkv * hd), d),
            "wo": norm_init(keys[4], (nl, hq * hd, d), d),
            "mlp_norm": jnp.ones((nl, d), dtype),
            "w_gate": norm_init(keys[5], (nl, d, f), d),
            "w_up": norm_init(keys[6], (nl, d, f), d),
            "w_down": norm_init(keys[7], (nl, f, d), f),
        },
        "final_norm": jnp.ones((d,), dtype),
    }


def param_count(params: Params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
