"""Batched decode engine: left-padded prefill + on-device greedy/sampled decode loop.

JAX replacement for the reference's vLLM usage (ref: scripts/generate.py:112-118).
Design:

- Prompts are **left-padded** to a bucketed length P, so every row's last prompt
  token sits at slot P-1 and decode writes to uniform slots P+t — no per-row
  scatter indices. Per-row ``pad_offsets`` shift RoPE positions and mask the pad
  slots out of attention.
- The whole generation (prefill + up to ``max_tokens`` decode steps) runs as ONE
  jitted call with a ``lax.while_loop`` that exits early when every row has hit a
  stop token — a single device dispatch per batch, no per-token host round-trips.
- Sampling: greedy argmax at temperature 0 (the reference's eval regime), else
  temperature/top-k/top-p categorical sampling; presence/frequency/repetition
  penalties supported via an on-device [B, V] count buffer (vLLM semantics).

Compiled programs are cached per (batch, prompt-bucket, max_tokens) shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import functools
import logging
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ssi_jax.models.configs import ConfigLlama3_2
from ssi_jax.models.llama3 import forward_slots, unembed

LOGGER = logging.getLogger(__name__)

_NEG_INF = -1.0e30


@dataclass(frozen=True)
class SamplingParams:
    """Decode-time sampling configuration (vLLM-compatible surface,
    ref: conf/generate.yaml:21-31)."""

    n: int = 1
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = -1
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = field(default_factory=tuple)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0

    @classmethod
    def from_cfg(cls, node: Any, stop_token_ids: list[int]) -> "SamplingParams":
        return cls(
            n=int(node.get("n", 1)),
            temperature=float(node.get("temperature", 0.0)),
            top_p=float(node.get("top_p", 1.0)),
            top_k=int(node.get("top_k", -1)),
            max_tokens=int(node.get("max_tokens", 256)),
            stop_token_ids=tuple(stop_token_ids),
            presence_penalty=float(node.get("presence_penalty", 0.0)),
            frequency_penalty=float(node.get("frequency_penalty", 0.0)),
            repetition_penalty=float(node.get("repetition_penalty", 1.0)),
        )

    @property
    def uses_penalties(self) -> bool:
        return self.presence_penalty != 0.0 or self.frequency_penalty != 0.0 or self.repetition_penalty != 1.0


from ssi_jax.utils import round_up as _round_up


def _sample(logits, sp: SamplingParams, key, out_counts, prompt_counts):
    """Next token + its logprob from [B, V] fp32 logits.

    Penalty scoping follows vLLM: repetition_penalty sees prompt+output tokens;
    presence/frequency penalties see output tokens only. The returned logprob is
    computed from the processed distribution (post-penalties, post-temperature,
    pre-top-k/p truncation — vLLM's logprob point).
    """
    if sp.uses_penalties:
        if sp.repetition_penalty != 1.0:
            appeared_any = (out_counts + prompt_counts) > 0
            logits = jnp.where(
                appeared_any,
                jnp.where(logits > 0, logits / sp.repetition_penalty, logits * sp.repetition_penalty),
                logits,
            )
        appeared_out = out_counts > 0
        logits = logits - sp.frequency_penalty * out_counts - sp.presence_penalty * appeared_out.astype(logits.dtype)

    if sp.temperature != 0.0:
        logits = logits / sp.temperature

    def logprob_of(tok):
        lse = jax.nn.logsumexp(logits, axis=-1)
        picked = jnp.take_along_axis(logits, tok[:, None], axis=-1)[:, 0]
        return picked - lse

    if sp.temperature == 0.0:
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return tok, key, logprob_of(tok)

    lp_logits = logits  # logprob point: before top-k/p truncation
    if 0 < sp.top_k < logits.shape[-1]:
        # top_k >= vocab is "disabled" (vLLM semantics), not an index error
        kth = jnp.sort(logits, axis=-1)[:, -sp.top_k][:, None]
        logits = jnp.where(logits < kth, _NEG_INF, logits)
    if sp.top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = jnp.sum(cum < sp.top_p, axis=-1)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
        logits = jnp.where(logits < cutoff, _NEG_INF, logits)
    key, sub = jax.random.split(key)
    tok = jax.random.categorical(sub, logits, axis=-1).astype(jnp.int32)
    lse = jax.nn.logsumexp(lp_logits, axis=-1)
    picked = jnp.take_along_axis(lp_logits, tok[:, None], axis=-1)[:, 0]
    return tok, key, picked - lse


class DecodeEngine:
    """Batched generation over a fixed parameter pytree.

    Args:
        params: model param pytree (bf16 recommended).
        cfg: architecture config (extended vocab).
        pad_id: token used to left-pad prompts (masked out of attention anyway).
        prompt_bucket: prompts pad up to a multiple of this (compile-cache key).
    """

    def __init__(self, params: Any, cfg: ConfigLlama3_2, pad_id: int, prompt_bucket: int = 128):
        self.params = params
        self.cfg = cfg
        self.pad_id = pad_id
        self.prompt_bucket = prompt_bucket
        self._compiled: dict[tuple, Any] = {}

    def _build(self, b: int, p: int, sp: SamplingParams):
        cfg = self.cfg
        max_t = sp.max_tokens
        m = p + max_t
        stop_ids = jnp.asarray(sp.stop_token_ids, jnp.int32) if sp.stop_token_ids else jnp.zeros((0,), jnp.int32)

        cache_dtype = self.params["embed"].dtype  # match param precision (fp32 tests, bf16 prod)

        def generate(params, tokens_padded, pad_offsets, key):
            cache = {
                "k": jnp.zeros((cfg.num_layers, b, m, cfg.num_kv_heads, cfg.head_dim), cache_dtype),
                "v": jnp.zeros((cfg.num_layers, b, m, cfg.num_kv_heads, cfg.head_dim), cache_dtype),
            }
            hidden, cache = forward_slots(params, tokens_padded, cfg, cache, jnp.int32(0), pad_offsets, p)
            last_logits = jnp.dot(
                hidden[:, -1, :], unembed(params).T, preferred_element_type=jnp.float32
            )  # [B, V]

            if sp.uses_penalties:
                out_counts0 = jnp.zeros((b, cfg.vocab_size), jnp.float32)
                # prompt counts feed only repetition_penalty (vLLM scoping); mask by
                # slot validity so left-padding never counts, even if pad_id is a
                # token that genuinely appears in the prompt
                slot_valid = (jnp.arange(p, dtype=jnp.int32)[None, :] >= pad_offsets[:, None]).astype(jnp.float32)
                prompt_counts = jnp.zeros((b, cfg.vocab_size), jnp.float32)
                prompt_counts = prompt_counts.at[jnp.arange(b)[:, None], tokens_padded].add(slot_valid)
            else:
                out_counts0 = jnp.zeros((1, 1), jnp.float32)
                prompt_counts = jnp.zeros((1, 1), jnp.float32)

            tok0, key0, clp0 = _sample(last_logits, sp, key, out_counts0, prompt_counts)

            out0 = jnp.full((b, max_t), self.pad_id, jnp.int32)
            done0 = jnp.isin(tok0, stop_ids) if stop_ids.size else jnp.zeros((b,), bool)
            out0 = out0.at[:, 0].set(tok0)
            lens0 = jnp.ones((b,), jnp.int32)

            def cond(state):
                t, done, *_ = state
                return jnp.logical_and(t < max_t, jnp.logical_not(jnp.all(done)))

            def body(state):
                t, done, tok, out, lens, cache, out_counts, key, clp = state
                hidden, cache = forward_slots(params, tok[:, None], cfg, cache, p - 1 + t, pad_offsets, 1)
                logits = jnp.dot(hidden[:, 0, :], unembed(params).T, preferred_element_type=jnp.float32)
                if sp.uses_penalties:
                    out_counts = out_counts.at[jnp.arange(b), tok].add(jnp.where(done, 0.0, 1.0))
                next_tok, key, lp = _sample(logits, sp, key, out_counts, prompt_counts)
                clp = clp + jnp.where(done, 0.0, lp)
                next_tok = jnp.where(done, self.pad_id, next_tok)
                out = out.at[:, t].set(jnp.where(done, out[:, t], next_tok))
                lens = lens + jnp.logical_not(done)
                is_stop = jnp.isin(next_tok, stop_ids) if stop_ids.size else jnp.zeros((b,), bool)
                done = jnp.logical_or(done, is_stop)
                return (t + 1, done, next_tok, out, lens, cache, out_counts, key, clp)

            # NOTE body at t consumes the token produced for slot p-1+t and emits out[:, t].
            state = (jnp.int32(1), done0, tok0, out0, lens0, cache, out_counts0, key0, clp0)
            t, done, tok, out, lens, cache, out_counts, key, clp = jax.lax.while_loop(cond, body, state)
            return out, lens, done, clp

        return jax.jit(generate, donate_argnums=())

    def generate_batch(
        self, prompts: list[list[int]], sp: SamplingParams, key: jax.Array | None = None
    ) -> list[dict[str, Any]]:
        """Generate for a batch of ragged prompts; returns vLLM-shaped dicts."""
        if sp.n != 1:
            raise ValueError(
                "DecodeEngine decodes one sequence per prompt; use PagedDecodeEngine for sampling_params.n > 1"
            )
        b = len(prompts)
        max_len = max(len(t) for t in prompts)
        p = _round_up(max_len, self.prompt_bucket)
        tokens = np.full((b, p), self.pad_id, np.int32)
        offsets = np.zeros((b,), np.int32)
        for i, t in enumerate(prompts):
            tokens[i, p - len(t) :] = t
            offsets[i] = p - len(t)

        cache_key = (b, p, sp)
        if cache_key not in self._compiled:
            self._compiled[cache_key] = self._build(b, p, sp)
        fn = self._compiled[cache_key]
        if key is None:
            key = jax.random.key(0)
        out, lens, done, clp = fn(self.params, jnp.asarray(tokens), jnp.asarray(offsets), key)
        out = np.asarray(out)
        lens = np.asarray(lens)
        done = np.asarray(done)
        clp = np.asarray(clp)

        results = []
        stop_set = set(sp.stop_token_ids)
        for i in range(b):
            token_ids = out[i, : lens[i]].tolist()
            stopped = bool(done[i]) and token_ids and token_ids[-1] in stop_set
            results.append(
                {
                    "token_ids": token_ids,
                    "finish_reason": "stop" if stopped else "length",
                    "stop_reason": token_ids[-1] if stopped else None,
                    "cumulative_logprob": float(clp[i]),
                }
            )
        return results
