"""Paged decode attention for NVIDIA GPUs: a Pallas kernel on the Triton route.

Single-token grouped-query attention over the flat paged pool
``[rows, ps, Hkv*hd]`` (generate/paged.py), read in place. The XLA gather path
(``paged.paged_attention``) copies every slot's whole ``max_pages`` window into a
dense view per layer per step and reads it again, so its bytes grow with
``max_context``; this kernel reads only each slot's valid pages, so its bytes grow
with the slot's length.

One program per (slot, KV head). The program loads the slot's length, walks its
page-table row over the valid pages only, and folds each page into flash-style
running statistics (max, sum, output) held in registers. The whole GQA group of
query heads shares each page read; the group is padded to 16 rows because a
Triton ``dot`` needs at least 16 rows. The token write stays with XLA's scatter
(``paged.write_token_kv``) ahead of the call.

``interpret=True`` runs the same kernel in the Pallas interpreter on the CPU; it is
reachable only through that explicit argument.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_MIN_DOT_ROWS = 16  # Triton dot operands need >= 16 rows
_NEG_INF = -1.0e30


def _kernel(lens_ref, table_ref, q_ref, k_ref, v_ref, o_ref, *, page_size: int, scale: float):
    # q_ref: [G16, hd] this (slot, kv head)'s query group; k_ref/v_ref: [rows, ps, hd]
    # views of the flat pool at this head's columns; table_ref: [max_pages] rows.
    slot = pl.program_id(0)
    length = lens_ref[slot]
    q = q_ref[...]
    g, hd = q.shape
    n_pages = (length + page_size - 1) // page_size

    def body(i, carry):
        o, m, l = carry
        row = table_ref[i]
        k = k_ref[row]  # [ps, hd]
        v = v_ref[row]
        s = pl.dot(q, k, trans_b=True).astype(jnp.float32) * scale  # [G16, ps]
        pos = i * page_size + jax.lax.broadcasted_iota(jnp.int32, (g, page_size), 1)
        s = jnp.where(pos < length, s, _NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        corr = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = corr * l + jnp.sum(p, axis=1)
        o = corr[:, None] * o + pl.dot(p.astype(v.dtype), v).astype(jnp.float32)
        return o, m_new, l

    o0 = jnp.zeros((g, hd), jnp.float32)
    m0 = jnp.full((g,), _NEG_INF, jnp.float32)
    l0 = jnp.zeros((g,), jnp.float32)
    o, _, l = jax.lax.fori_loop(0, n_pages, body, (o0, m0, l0))
    # a zero-length (inactive) slot reads no page and returns zeros
    o_ref[...] = jnp.where(l[:, None] > 0, o / jnp.maximum(l, 1e-30)[:, None], 0.0).astype(o_ref.dtype)


@functools.partial(jax.jit, static_argnames=("interpret",))
def paged_attention_triton(
    q: jnp.ndarray,
    k_pool: jnp.ndarray,
    v_pool: jnp.ndarray,
    phys_table: jnp.ndarray,
    seq_lens: jnp.ndarray,
    *,
    interpret: bool = False,
) -> jnp.ndarray:
    """Same contract as ``paged.paged_attention``.

    q: [slots, Hq, hd] (post-RoPE); k_pool/v_pool: [rows, ps, Hkv*hd];
    phys_table: [slots, max_pages] PHYSICAL rows; seq_lens: [slots] valid cache
    tokens including the current one. Returns [slots, Hq, hd] in q's dtype.
    ``page_size`` and ``hd`` must be powers of two >= 16 (Triton block shapes).
    """
    n_slots, hq, hd = q.shape
    rows, ps, kvd = k_pool.shape
    hkv = kvd // hd
    n_rep = hq // hkv
    max_pages = phys_table.shape[1]
    for name, n in (("page_size", ps), ("head_dim", hd)):
        if n < 16 or n & (n - 1):
            raise ValueError(f"paged_attention_triton needs a power-of-two {name} >= 16, got {n}")
    g16 = max(_MIN_DOT_ROWS, 1 << (n_rep - 1).bit_length())
    qg = q.reshape(n_slots, hkv, n_rep, hd)
    if g16 != n_rep:
        qg = jnp.pad(qg, ((0, 0), (0, 0), (0, g16 - n_rep), (0, 0)))
    kernel = functools.partial(_kernel, page_size=ps, scale=1.0 / math.sqrt(hd))
    out = pl.pallas_call(
        kernel,
        grid=(n_slots, hkv),
        in_specs=[
            pl.BlockSpec((n_slots,), lambda s, h: (0,)),
            pl.BlockSpec((None, max_pages), lambda s, h: (s, 0)),
            pl.BlockSpec((None, None, g16, hd), lambda s, h: (s, h, 0, 0)),
            pl.BlockSpec((rows, ps, hd), lambda s, h: (0, 0, h)),
            pl.BlockSpec((rows, ps, hd), lambda s, h: (0, 0, h)),
        ],
        out_specs=pl.BlockSpec((None, None, g16, hd), lambda s, h: (s, h, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_slots, hkv, g16, hd), q.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="paged_decode_attention",
    )(seq_lens.astype(jnp.int32), phys_table.astype(jnp.int32), qg, k_pool, v_pool)
    return out[:, :, :n_rep].reshape(n_slots, hq, hd)
