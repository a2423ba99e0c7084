"""Jitted train / eval step builders — the functional core of training.

Accelerator-first reshaping of the reference hot loop (ref: ssi/trainer.py:385-436):
the reference runs ``grad_accum`` separate forward/backward host iterations per
optimizer step; here one jitted call consumes the whole accumulation window as a
``[accum, batch, seq]`` array and runs a ``lax.scan`` over micro-batches — a single
compiled program per optimizer step, no host round-trips, async dispatch.

Semantics preserved exactly:
- per-micro-batch loss = sum of NLL over non-ignored (shifted) labels
  (ref: ssi/loss.py:7-22 shift; ssi/trainer.py:391-393 scale-by-token-count);
- at the window boundary grads are scaled by 1/num_tokens_step, optionally clipped
  by global norm, then AdamW + schedule (ref: ssi/trainer.py:397-412);
- a window with zero non-ignored tokens applies no update and does not advance
  ``step`` (ref: ssi/trainer.py:399-402);
- token-type accounting over vocab ranges runs on device (ref: ssi/train_utils.py:150-165).

The train state is one pytree ``{params, opt_state, step}`` threaded through the
step and donated, so params/optimizer buffers update in place on device.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import jax
import jax.numpy as jnp

from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_jax.models.configs import ConfigLlama3_2
from ssi_jax.models.llama3 import forward
from ssi_jax.ops.cross_entropy import fused_cross_entropy
from ssi_jax.train.optimizer import AdamWConfig, adamw_update, clip_by_global_norm

LOGGER = logging.getLogger(__name__)

TrainState = dict[str, Any]  # {"params": pytree, "opt_state": pytree, "step": int32}


def shift_labels(labels: jnp.ndarray) -> jnp.ndarray:
    """Next-token shift: label[i] := label[i+1]; final position ignored.

    (ref: ssi/loss.py:16 — torch.hstack((labels[..., 1:], ignore_idx column)))
    """
    b = labels.shape[0]
    pad_col = jnp.full((b, 1), CROSS_ENTROPY_IGNORE_IDX, labels.dtype)
    return jnp.concatenate([labels[:, 1:], pad_col], axis=1)


def shift_labels_packed(labels: jnp.ndarray, segment_ids: jnp.ndarray) -> jnp.ndarray:
    """Next-token shift that never crosses a pack boundary: positions whose
    successor belongs to a different segment get the ignore index."""
    shifted = shift_labels(labels)
    next_seg = jnp.concatenate([segment_ids[:, 1:], jnp.zeros_like(segment_ids[:, :1])], axis=1)
    same_segment = next_seg == segment_ids
    return jnp.where(same_segment, shifted, CROSS_ENTROPY_IGNORE_IDX)


def make_loss_fn(
    model_cfg: ConfigLlama3_2,
    *,
    attn_impl: str = "auto",
    remat: bool | str = True,
    chunk_size: int = 1024,
) -> Callable:
    """(params, tokens [B,S], labels [B,S], segment_ids?, positions?) ->
    (loss_sum f32, num_tokens i32).

    With ``segment_ids``/``positions`` (packed sequences), attention is restricted
    to equal segments and the label shift stops at pack boundaries.
    """

    def loss_fn(params, tokens, labels, segment_ids=None, positions=None):
        hidden = forward(
            params, tokens, model_cfg, positions=positions, segment_ids=segment_ids,
            attn_impl=attn_impl, remat=remat,
        )
        if segment_ids is None:
            y = shift_labels(labels).reshape(-1)
        else:
            y = shift_labels_packed(labels, segment_ids).reshape(-1)
        h = hidden.reshape(-1, hidden.shape[-1])
        # tied embedding (1B/3B) or the separate lm_head (8B) — the fused CE only
        # needs "the [V, D] output matrix", whichever the architecture ships
        loss_sum = fused_cross_entropy(h, params.get("lm_head", params["embed"]), y, chunk_size)
        num_tokens = jnp.sum(y != CROSS_ENTROPY_IGNORE_IDX).astype(jnp.int32)
        return loss_sum, num_tokens

    return loss_fn


def count_token_types_device(
    tokens: jnp.ndarray,
    ranges: dict[str, tuple[int, int]],
    pad_id: int,
) -> dict[str, jnp.ndarray]:
    """Device-side token-type accounting (ref: ssi/train_utils.py:150-165).

    Padding positions (``tokens == pad_id``) are excluded from every range so the
    ``n_tokens.*`` curves are invariant to the padding policy (batch-max vs fixed
    max_seq_len) and comparable across runs — the reference's batch-max padding
    would otherwise skew ``special_text`` by the pad count.
    """
    counts = {}
    real = tokens != pad_id
    for token_type, (start, end) in ranges.items():
        counts[token_type] = jnp.sum((tokens >= start) & (tokens <= end) & real).astype(jnp.int32)
    counts["total"] = jnp.sum(real).astype(jnp.int32)
    return counts


def make_train_step(
    model_cfg: ConfigLlama3_2,
    opt_cfg: AdamWConfig,
    lr_schedule: Callable,
    *,
    clip_grad_norm: float | None = None,
    token_type_ranges: dict[str, tuple[int, int]] | None = None,
    pad_id: int = 0,
    attn_impl: str = "auto",
    remat: bool | str = True,
    chunk_size: int = 1024,
    grad_accum_dtype=jnp.float32,
    donate: bool = True,
    state_shardings: dict | None = None,
    accum_unroll: int = 1,
    deterministic: bool = False,
) -> Callable[[TrainState, jnp.ndarray, jnp.ndarray], tuple[TrainState, dict[str, jnp.ndarray]]]:
    """Build the jitted optimizer-step function.

    The returned callable maps ``(state, tokens [A,B,S], labels [A,B,S])`` to
    ``(new_state, metrics)`` where A is the accumulation window.

    ``state_shardings``: optional ``{"params": ..., "opt_state": ...}`` NamedSharding
    trees pinning the output layout. Used for ZeRO-1 (dp-sharded optimizer moments):
    constraining grads + new moments to the dp-sharded layout makes XLA reduce-
    scatter gradients into a partitioned update and all-gather the fresh params —
    all-reduce bytes, 1/dp the persistent moment HBM and update compute.

    ``attn_impl="auto"`` resolves per platform and compute dtype when the step
    traces (``ops.attention.resolve_attn_impl``).

    ``deterministic``: compile this step with ``xla_gpu_deterministic_ops``. On
    the GPU the embedding gradient's scatter-add otherwise runs on atomics whose
    order changes from run to run, so a resumed run drifts from the uninterrupted
    one in the last bits; with it, resume is bit-identical, at a large cost in
    step time (PERF.md). Only this program gets the option; the CPU ignores it.
    """
    loss_fn = make_loss_fn(model_cfg, attn_impl=attn_impl, remat=remat, chunk_size=chunk_size)
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def train_step(state: TrainState, tokens: jnp.ndarray, labels: jnp.ndarray, segment_ids=None, positions=None):
        params = state["params"]

        if tokens.shape[0] == 1:
            # No accumulation: skip the fp32 accumulator buffer entirely (grads stay
            # in param dtype — 2x less HBM for the single-window case).
            (loss_sum, num_tokens), grads = grad_fn(
                params, tokens[0], labels[0],
                None if segment_ids is None else segment_ids[0],
                None if positions is None else positions[0],
            )
        else:

            def micro(carry, xs):
                g_acc, loss_acc, ntok_acc = carry
                tk, lb, seg, pos = xs
                (loss_sum, num_tokens), g = grad_fn(params, tk, lb, seg, pos)
                g_acc = jax.tree.map(lambda a, gg: a + gg.astype(grad_accum_dtype), g_acc, g)
                return (g_acc, loss_acc + loss_sum, ntok_acc + num_tokens), None

            g_init = jax.tree.map(lambda p: jnp.zeros(p.shape, grad_accum_dtype), params)
            # accum_unroll > 1 lets XLA fuse consecutive micro-batch adds into one
            # accumulator read/write pass (halves the g_acc HBM traffic at 2).
            (grads, loss_sum, num_tokens), _ = jax.lax.scan(
                micro,
                (g_init, jnp.float32(0.0), jnp.int32(0)),
                (tokens, labels, segment_ids, positions),
                unroll=accum_unroll,
            )

        # Scale by 1/num_tokens_step (ref: ssi/trainer.py:404); guard div-by-zero.
        denom = jnp.maximum(num_tokens, 1).astype(jnp.float32)
        grads = jax.tree.map(lambda g: g / denom, grads)

        if state_shardings is not None:
            # Pin grads to the moment layout here so the dp reduce-scatter happens
            # once, before clipping — the norm is a psum over shards either way.
            grads = jax.lax.with_sharding_constraint(grads, state_shardings["opt_state"]["mu"])

        if clip_grad_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, float(clip_grad_norm))
        else:
            grad_norm = jnp.float32(jnp.nan)

        lr = lr_schedule(state["step"])

        # Zero-token window: no update, no step advance (ref: ssi/trainer.py:399-402).
        # lax.cond (not where-selects) so the skip path costs no HBM traffic over the
        # ~12.5 GB of param + optimizer state.
        applied = num_tokens > 0

        def do_update(operand):
            grads_, opt_state_, params_ = operand
            return adamw_update(grads_, opt_state_, params_, lr, opt_cfg)

        def skip_update(operand):
            _, opt_state_, params_ = operand
            return params_, opt_state_

        new_params, new_opt_state = jax.lax.cond(
            applied, do_update, skip_update, (grads, state["opt_state"], params)
        )
        if state_shardings is not None:
            new_params = jax.lax.with_sharding_constraint(new_params, state_shardings["params"])
            new_opt_state = jax.lax.with_sharding_constraint(new_opt_state, state_shardings["opt_state"])
        new_state = {
            "params": new_params,
            "opt_state": new_opt_state,
            "step": state["step"] + applied.astype(jnp.int32),
        }

        metrics = {
            "loss_sum": loss_sum,
            "num_tokens": num_tokens,
            "grad_norm": grad_norm,
            "lr": jnp.asarray(lr, jnp.float32),
            "applied": applied,
        }
        if token_type_ranges is not None:
            metrics["token_counts"] = count_token_types_device(tokens, token_type_ranges, pad_id)
        return new_state, metrics

    compiler_options = {"xla_gpu_deterministic_ops": True} if deterministic else None
    return jax.jit(train_step, donate_argnums=(0,) if donate else (), compiler_options=compiler_options)


def make_eval_step(
    model_cfg: ConfigLlama3_2,
    *,
    attn_impl: str = "auto",
    chunk_size: int = 1024,
) -> Callable[[Any, jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]:
    """Jitted dev-loss step: (params, tokens [B,S], labels [B,S]) -> (loss_sum, n_tokens).

    No remat (no backward pass), no state mutation (ref: ssi/eval.py:15-41).
    """
    loss_fn = make_loss_fn(model_cfg, attn_impl=attn_impl, remat=False, chunk_size=chunk_size)

    @jax.jit
    def eval_step(params, tokens, labels, segment_ids=None, positions=None):
        return loss_fn(params, tokens, labels, segment_ids, positions)

    return eval_step


def compute_dataset_loss(
    eval_step: Callable,
    params: Any,
    loader: Any,
    *,
    put_batch: Callable[[dict[str, Any]], tuple[jnp.ndarray, jnp.ndarray]] | None = None,
    log_every: int = 0,
) -> float:
    """Token-weighted mean dev loss over a loader (ref: ssi/eval.py:15-41)."""
    loss_running = 0.0
    num_tokens = 0
    n_batches = len(loader)
    for i, batch in enumerate(loader):
        if put_batch is not None:
            arrays = put_batch(batch)
        else:
            has_seg, has_pos = "segment_ids" in batch, "positions" in batch
            if has_seg != has_pos:
                raise ValueError("Packed batches must carry BOTH segment_ids and positions (got one without the other)")
            keys = ["tokens", "labels"] + (["segment_ids", "positions"] if has_seg else [])
            arrays = tuple(jnp.asarray(batch[k]) for k in keys)
        loss_sum, ntok = eval_step(params, *arrays)
        loss_running += float(loss_sum)
        num_tokens += int(ntok)
        if log_every and (i % log_every == 0):
            LOGGER.info(f"Dev batch {i}/{n_batches} | batch loss sum {float(loss_sum):.4f}")
    if num_tokens == 0:
        return float("nan")
    return loss_running / num_tokens
