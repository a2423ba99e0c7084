"""Block-paged KV cache + paged attention for the continuous-batching engine.

JAX replacement for vLLM's paged attention (ref: scripts/generate.py:112 relies on
vLLM's CUDA paged-attention kernels). Design:

- ONE flat physical pool per K and V: ``[L*n_pages + 1, ps, Hkv*hd]``. A
  logical page id ``p`` of layer ``l`` lives at physical row ``l*n_pages + p``,
  so per-layer access is a page-id *offset*, never an array slice: scanning
  layer-sliced pools through the decode loop would cost a dynamic-slice +
  dynamic-update-slice of a whole layer slice per layer per token, while with
  the flat pool the per-layer cache update is a one-row-per-slot scatter and the
  whole pool rides the scan carry in place.
- The LAST physical row is a **trash page**: writes that must happen shape-wise
  but carry no information (prefill padding rows/positions) are pointed there.
- A host-side free list allocates logical pages lazily (the scheduler in
  paged_engine.py); a **page table** ``[slots, max_pages]`` maps each decode
  slot's logical blocks to logical page ids; ``seq_lens [slots]`` gives the
  valid length. Sequences are not padded: RoPE positions equal true indices.
- Decode attention, by ``attn_impl``:
  - ``"gather"`` (``paged_attention``, XLA): gathers each slot's pages into a
    dense view — the plain reference, runs everywhere (CPU tests);
  - ``"triton"`` (``paged_triton.paged_attention_triton``): a Pallas kernel on
    the Triton route that reads only each slot's valid pages in place.
- Prefill is **batched**: ``prefill_prompts`` takes ``[B, P]`` right-padded
  prompts and writes all their pages in one dispatch (one weights read for B
  prompts instead of B). Its attention is ``prefill_impl``: the einsum
  ``prefill_attention`` (``"xla"``) or cuDNN's fused attention (``"cudnn"``).

All functions are shape-static; masking by ``seq_lens`` handles raggedness, so
one compiled program serves every mix of prompt/output lengths.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ssi_jax.generate.quant import matmul as _mm
from ssi_jax.models.configs import ConfigLlama3_2
from ssi_jax.models.llama3 import rms_norm, unembed
from ssi_jax.models.rope import apply_rope, rope_cos_sin
from ssi_jax.ops.attention import cudnn_attention

NEG_INF = -1.0e30


def init_pools(cfg: ConfigLlama3_2, n_pages: int, page_size: int, dtype=jnp.bfloat16) -> dict[str, jnp.ndarray]:
    """Flat paged K/V pools: ``[L*n_pages + 1, ps, Hkv*hd]`` (+1 = trash page).

    Pages are stored head-flattened (``Hkv*hd`` = 512 columns for the 1B
    config); the decode kernel reads one head's columns of a page in place, so
    no reshape or transpose of the pool sits between the scan carry and the
    kernel call.

    ``n_pages`` is the LOGICAL (per-layer) pool size; callers thread it as a
    static python int (it determines physical row arithmetic, not a traced
    value).
    """
    shape = (cfg.num_layers * n_pages + 1, page_size, cfg.num_kv_heads * cfg.head_dim)
    return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}


def write_token_kv(pool: jnp.ndarray, kv: jnp.ndarray,
                   phys_ids: jnp.ndarray, offsets: jnp.ndarray, active: jnp.ndarray) -> jnp.ndarray:
    """Scatter one new token's K or V per slot into its physical page.

    pool: [rows, ps, Hkv*hd] (flat); kv: [slots, Hkv, hd]; phys_ids/offsets:
    [slots] physical row and in-page offset; active: [slots] bool — inactive
    slots are redirected to the trash page (scatter must be total for XLA).
    """
    trash = pool.shape[0] - 1
    rows = jnp.where(active, phys_ids, trash)
    return pool.at[rows, offsets].set(kv.astype(pool.dtype).reshape(kv.shape[0], -1))


def gather_pages(pool: jnp.ndarray, phys_table: jnp.ndarray, hkv: int) -> jnp.ndarray:
    """Dense view of one layer's pages: [slots, max_pages*ps, Hkv, hd]."""
    n_slots, max_pages = phys_table.shape
    g = pool[phys_table]  # [slots, max_pages, ps, Hkv*hd]
    return g.reshape(n_slots, max_pages * pool.shape[1], hkv, pool.shape[2] // hkv)


def paged_attention(
    q: jnp.ndarray,
    k_pool: jnp.ndarray,
    v_pool: jnp.ndarray,
    phys_table: jnp.ndarray,
    seq_lens: jnp.ndarray,
) -> jnp.ndarray:
    """Single-token grouped-query attention over the flat paged pool (XLA gather).

    q: [slots, Hq, hd] (post-RoPE); k_pool/v_pool: [rows, ps, Hkv*hd];
    phys_table: [slots, max_pages] PHYSICAL rows (layer offset applied);
    seq_lens: [slots] — valid cache tokens INCLUDING the current one (already
    written). Returns [slots, Hq, hd].
    """
    n_slots, hq, hd = q.shape
    hkv = k_pool.shape[2] // hd
    n_rep = hq // hkv

    k = gather_pages(k_pool, phys_table, hkv)  # [S, M, Hkv, hd]
    v = gather_pages(v_pool, phys_table, hkv)
    m = k.shape[1]

    qg = q.reshape(n_slots, hkv, n_rep, hd)
    scale = 1.0 / (hd**0.5)
    logits = jnp.einsum("bkgd,bmkd->bkgm", qg, k.astype(q.dtype), preferred_element_type=jnp.float32) * scale
    valid = jnp.arange(m, dtype=jnp.int32)[None, :] < seq_lens[:, None]  # [S, M]
    logits = jnp.where(valid[:, None, None, :], logits, NEG_INF)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkgm,bmkd->bkgd", probs.astype(v.dtype), v)
    return out.reshape(n_slots, hq, hd)


DECODE_IMPLS = ("gather", "triton")
# "auto" per platform: the valid-pages-only kernel on the GPU, the gather reference on the CPU
_AUTO_DECODE = {"gpu": "triton", "cpu": "gather"}


def resolve_decode_impl(impl: str, platform: str | None = None) -> str:
    """Name the decode attention that runs: ``"auto"`` resolves by the platform of
    the first device (or ``platform``); unknown names and platforms raise."""
    if impl == "auto":
        platform = platform or jax.devices()[0].platform
        if platform not in _AUTO_DECODE:
            raise ValueError(f"No decode attention implementation for platform {platform!r}")
        return _AUTO_DECODE[platform]
    if impl not in DECODE_IMPLS:
        raise ValueError(f"Unknown decode attention impl: {impl!r}; expected one of {DECODE_IMPLS} or 'auto'")
    return impl


def decode_attention_fn(attn_impl: str):
    """The single-token paged attention that ``attn_impl`` names."""
    if attn_impl == "gather":
        return paged_attention
    if attn_impl == "triton":
        from ssi_jax.generate.paged_triton import paged_attention_triton

        return paged_attention_triton
    raise ValueError(f"Unknown decode attention impl: {attn_impl!r}; expected one of {DECODE_IMPLS}")


def paged_attention_multi(
    q: jnp.ndarray,
    k_pool: jnp.ndarray,
    v_pool: jnp.ndarray,
    phys_table: jnp.ndarray,
    base_lens: jnp.ndarray,
) -> jnp.ndarray:
    """Multi-token grouped-query attention over the paged pool (XLA gather) —
    the verification pass of speculative decoding.

    q: [slots, T, Hq, hd] (post-RoPE) — T draft tokens per slot at positions
    ``base_lens-1 .. base_lens-1+T-1`` (all T written to pages beforehand);
    base_lens: [slots] valid cache length INCLUDING the first draft token, so
    draft token j attends over ``base_lens + j`` entries (its predecessors in
    the draft included, its successors masked). Returns [slots, T, Hq, hd].
    """
    n_slots, t_q, hq, hd = q.shape
    hkv = k_pool.shape[2] // hd
    n_rep = hq // hkv

    k = gather_pages(k_pool, phys_table, hkv)  # [S, M, Hkv, hd]
    v = gather_pages(v_pool, phys_table, hkv)
    m = k.shape[1]

    qg = q.reshape(n_slots, t_q, hkv, n_rep, hd)
    scale = 1.0 / (hd**0.5)
    logits = jnp.einsum("btkgd,bmkd->bkgtm", qg, k.astype(q.dtype), preferred_element_type=jnp.float32) * scale
    pos = jnp.arange(m, dtype=jnp.int32)[None, None, :]                      # [1, 1, M]
    lens = base_lens[:, None, None] + jnp.arange(t_q, dtype=jnp.int32)[None, :, None]
    valid = pos < lens                                                       # [S, T, M]
    logits = jnp.where(valid[:, None, None, :, :], logits, NEG_INF)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkgtm,bmkd->btkgd", probs.astype(v.dtype), v)
    return out.reshape(n_slots, t_q, hq, hd)


def prefill_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Causal self-attention over right-padded prompts (batched prefill).

    q: [B, T, Hq, hd]; k/v: [B, T, Hkv, hd]. Padding positions produce garbage
    that lands on trash/overwritten pages — valid prefixes are causally isolated.
    Returns [B, T, Hq, hd].
    """
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    qg = q.reshape(b, t, hkv, n_rep, hd)
    scale = 1.0 / (hd**0.5)
    logits = jnp.einsum("btkgd,bmkd->bkgtm", qg, k.astype(q.dtype), preferred_element_type=jnp.float32) * scale
    causal = jnp.arange(t, dtype=jnp.int32)[:, None] >= jnp.arange(t, dtype=jnp.int32)[None, :]
    logits = jnp.where(causal[None, None, None, :, :], logits, NEG_INF)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkgtm,bmkd->btkgd", probs.astype(v.dtype), v)
    return out.reshape(b, t, hq, hd)


# ----------------------------------------------------------------------------------
# Model passes over the paged cache
# ----------------------------------------------------------------------------------


def _rope_for_positions(positions: jnp.ndarray, cfg: ConfigLlama3_2):
    return rope_cos_sin(
        positions,
        cfg.head_dim,
        rope_base=cfg.rope_base,
        scale_factor=cfg.scale_factor,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_seq_len=cfg.rope_original_max_seq_len,
    )


def _layer_scan(params, cfg: ConfigLlama3_2, h, kp, vp, cos, sin, attend):
    """Shared per-layer transformer scaffold for every paged-cache pass.

    ``h``: [B, T, D] embedded inputs; ``attend(q, k, v, kp, vp, l)`` is the
    only part the four passes (single-token decode, speculative verify, prompt
    prefill, suffix prefill) differ in — it writes K/V into the pools however
    the pass requires and returns ``(attn [B, T, Hq, hd], kp, vp)``. Everything
    is trace-time python, so the shared scaffold costs nothing at runtime.
    Returns ``(h [B, T, D] — NOT final-normed, kp, vp)``.
    """
    b, t = h.shape[0], h.shape[1]
    hd = cfg.head_dim

    def body(carry, layer):
        h, kp, vp, l = carry
        x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
        q = _mm(x, layer["wq"]).reshape(b, t, cfg.num_heads, hd)
        k = _mm(x, layer["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
        v = _mm(x, layer["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn, kp, vp = attend(q, k, v, kp, vp, l)
        h = h + _mm(attn.reshape(b, t, cfg.num_heads * hd).astype(h.dtype), layer["wo"])
        x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
        h = h + _mm(jax.nn.silu(_mm(x, layer["w_gate"])) * _mm(x, layer["w_up"]), layer["w_down"])
        return (h, kp, vp, l + 1), None

    (h, kp, vp, _), _ = jax.lax.scan(body, (h, kp, vp, jnp.int32(0)), params["layers"])
    return h, kp, vp


def decode_step_tokens(
    params: Any,
    tokens: jnp.ndarray,
    cfg: ConfigLlama3_2,
    pools: dict[str, Any],
    page_table: jnp.ndarray,
    seq_lens: jnp.ndarray,
    active: jnp.ndarray,
    *,
    n_pages: int,
    attn_impl: str = "gather",
) -> tuple[jnp.ndarray, dict[str, Any]]:
    """Advance every active slot by ONE token over the flat paged cache.

    tokens: [slots] current input token per slot; seq_lens: [slots] valid cache
    length BEFORE this token; page_table: [slots, max_pages] LOGICAL page ids.
    Writes the new K/V at position ``seq_lens``, attends over ``seq_lens + 1``
    entries, returns (fp32 logits [slots, V], pools).
    """
    ps = pools["k"].shape[1]
    positions = seq_lens[:, None]  # [slots, 1] — position of the incoming token
    cos, sin = _rope_for_positions(positions, cfg)  # [slots, 1, hd]

    page_idx = seq_lens // ps
    logical_ids = jnp.take_along_axis(page_table, page_idx[:, None], axis=1)[:, 0]
    offsets = seq_lens % ps
    # attend over history + self; inactive slots (done/freed) get attn_len 0 so
    # the kernel reads ZERO history pages for them — a done slot idling through
    # its pipeline-depth tail otherwise keeps streaming its whole cache every
    # step of every layer (their outputs are where-discarded upstream anyway)
    attn_lens = jnp.where(active, seq_lens + 1, 0)

    h = params["embed"][tokens][:, None, :]  # [slots, 1, D]

    attn_fn = decode_attention_fn(attn_impl)

    def attend(q, k, v, kp, vp, l):
        base = l * n_pages
        phys_table = base + page_table  # [slots, max_pages]
        q, k, v = q[:, 0], k[:, 0], v[:, 0]  # single-token kernels take [slots, H, hd]
        kp = write_token_kv(kp, k, base + logical_ids, offsets, active)
        vp = write_token_kv(vp, v, base + logical_ids, offsets, active)
        attn = attn_fn(q, kp, vp, phys_table, attn_lens)
        return attn[:, None], kp, vp

    h, kp, vp = _layer_scan(params, cfg, h, pools["k"], pools["v"], cos, sin, attend)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    logits = jnp.dot(h, unembed(params).T, preferred_element_type=jnp.float32)
    return logits, {"k": kp, "v": vp}


def decode_step_tokens_spec(
    params: Any,
    tokens: jnp.ndarray,
    cfg: ConfigLlama3_2,
    pools: dict[str, Any],
    page_table: jnp.ndarray,
    seq_lens: jnp.ndarray,
    active: jnp.ndarray,
    cap_lens: jnp.ndarray,
    *,
    n_pages: int,
) -> tuple[jnp.ndarray, dict[str, Any]]:
    """Speculative verification step: advance every active slot by T candidate
    tokens over the flat paged cache in ONE forward (one weights read for T
    tokens — the whole point of speculation on a weights-bandwidth-bound step).

    tokens: [slots, T] — column 0 is the slot's true next input token, columns
    1..T-1 are n-gram draft candidates; seq_lens: [slots] valid cache length
    BEFORE this step (token j sits at position ``seq_lens + j``); cap_lens:
    [slots] hard per-slot write bound — draft positions at/beyond it land on
    the trash page (they could never be emitted: the engine's page provisioning
    and the budget both stop before ``cap_lens``).

    K/V of ALL T tokens are written at their positions; rejected candidates
    leave garbage beyond the accepted prefix that the advancing ``seq_lens``
    masks and later tokens overwrite — the standard speculative-cache argument.
    Returns (fp32 logits [slots, T, V], pools).
    """
    ps = pools["k"].shape[1]
    n_slots, t_q = tokens.shape
    positions = seq_lens[:, None] + jnp.arange(t_q, dtype=jnp.int32)[None, :]  # [slots, T]
    cos, sin = _rope_for_positions(positions, cfg)  # [slots, T, hd]

    max_pages = page_table.shape[1]
    page_idx = jnp.clip(positions // ps, 0, max_pages - 1)
    logical_ids = jnp.take_along_axis(page_table, page_idx, axis=1)  # [slots, T]
    offsets = positions % ps
    write_ok = jnp.logical_and(active[:, None], positions < cap_lens[:, None])
    attn_lens = seq_lens + 1  # token j attends over attn_lens + j entries

    h = params["embed"][tokens]  # [slots, T, D]

    trash = pools["k"].shape[0] - 1

    def attend(q, k, v, kp, vp, l):
        base = l * n_pages
        phys_table = base + page_table
        write_rows = jnp.where(write_ok, base + logical_ids, trash)  # [slots, T]
        for t in range(t_q):  # static T: unrolled scatter per candidate
            kp = kp.at[write_rows[:, t], offsets[:, t]].set(
                k[:, t].astype(kp.dtype).reshape(n_slots, -1)
            )
            vp = vp.at[write_rows[:, t], offsets[:, t]].set(
                v[:, t].astype(vp.dtype).reshape(n_slots, -1)
            )
        attn = paged_attention_multi(q, kp, vp, phys_table, attn_lens)
        return attn, kp, vp

    h, kp, vp = _layer_scan(params, cfg, h, pools["k"], pools["v"], cos, sin, attend)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = jnp.dot(h, unembed(params).T, preferred_element_type=jnp.float32)
    return logits, {"k": kp, "v": vp}


def prefill_prompts(
    params: Any,
    tokens: jnp.ndarray,
    cfg: ConfigLlama3_2,
    pools: dict[str, Any],
    page_ids: jnp.ndarray,
    *,
    n_pages: int,
    prefill_impl: str = "xla",
    hist: jnp.ndarray | None = None,
    slot_ids: jnp.ndarray | None = None,
) -> dict[str, Any] | tuple[dict[str, Any], jnp.ndarray]:
    """Prefill a BATCH of prompts into their pages (K/V write only — no logits).

    With ``hist`` (+ ``slot_ids`` [B], speculative decoding): each row's tokens
    are also recorded into the token-history buffer ``hist [n_slots+1, W]``
    (last row = trash for pad rows) and ``(pools, hist)`` is returned — the
    n-gram drafter matches against the prompt itself, where ASR-style traffic
    gets most of its acceptance.

    tokens: [B, P] right-padded to the shared bucket length; page_ids:
    [B, P // ps] LOGICAL pages receiving each prompt's K/V — point unused rows
    or beyond-own-bucket positions at the trash page id
    (``n_pages`` works: physical ``l*n_pages + n_pages`` < trash row only for
    l < L-1; use ``trash_logical_id`` below for the always-safe id). Pad
    positions' K/V land in slot-owned or trash pages; decode masks them via
    seq_lens and overwrites in place as real tokens reach those offsets.

    The caller seeds decode at ``len - 1`` so the first chunk step recomputes
    the last prompt position and samples the first output on device — admission
    stays free of host round trips.

    Returns the updated pools.
    """
    b, p = tokens.shape
    ps = pools["k"].shape[1]
    assert p % ps == 0, (p, ps)
    positions = jnp.arange(p, dtype=jnp.int32)[None, :]
    cos, sin = _rope_for_positions(positions, cfg)
    hd = cfg.head_dim
    trash = pools["k"].shape[0] - 1

    h = params["embed"][tokens]  # [B, P, D]

    if prefill_impl == "cudnn":
        # fused causal attention with native GQA: no [B, H, P, P] f32 logits in
        # device memory (the einsum path materializes them)
        attn_fn = lambda q, k, v: cudnn_attention(q, k, v, causal=True)
    elif prefill_impl == "xla":
        attn_fn = prefill_attention
    else:
        raise ValueError(f"Unknown prefill impl: {prefill_impl!r}; expected 'xla' or 'cudnn'")

    def attend(q, k, v, kp, vp, l):
        attn = attn_fn(q, k, v)
        # write pages: [B, P] -> [B*P//ps, ps, Hkv, hd] at physical rows
        phys = jnp.where(page_ids >= n_pages, trash, l * n_pages + page_ids).reshape(-1)
        kp = kp.at[phys].set(k.astype(kp.dtype).reshape(b * p // ps, ps, cfg.num_kv_heads * hd))
        vp = vp.at[phys].set(v.astype(vp.dtype).reshape(b * p // ps, ps, cfg.num_kv_heads * hd))
        return attn, kp, vp

    _, kp, vp = _layer_scan(params, cfg, h, pools["k"], pools["v"], cos, sin, attend)
    pools = {"k": kp, "v": vp}
    if hist is None:
        return pools
    hist = hist.at[slot_ids, :p].set(tokens)
    return pools, hist


def prefill_suffix(
    params: Any,
    tokens: jnp.ndarray,
    start: jnp.ndarray,
    cfg: ConfigLlama3_2,
    pools: dict[str, Any],
    page_table: jnp.ndarray,
    page_ids_new: jnp.ndarray,
    *,
    n_pages: int,
    hist: jnp.ndarray | None = None,
    full_tokens: jnp.ndarray | None = None,
    slot_ids: jnp.ndarray | None = None,
) -> dict[str, Any] | tuple[dict[str, Any], jnp.ndarray]:
    """Prefill the UNCACHED TAIL of prompts whose prefix K/V pages came from
    the cross-request prefix cache (vLLM's automatic-prefix-caching role; the
    reference reaches it through vLLM at scripts/generate.py:112-118).

    tokens: [B, S] suffix tokens at absolute positions ``start .. start+S-1``,
    right-padded to the shared suffix bucket (S % page_size == 0); start: [B]
    cached token count per row (a multiple of page_size — only FULL prompt
    pages are cached); page_table: [B, max_pages] logical pages covering the
    cached prefix AND the slot-owned suffix pages (trash-padded beyond);
    page_ids_new: [B, S // ps] logical pages receiving the suffix K/V.

    Per layer the suffix K/V is scattered into its pages FIRST, then
    ``paged_attention_multi`` attends each suffix token over the gathered page
    view — cached history and in-suffix predecessors in one joint softmax
    (flat gather position == absolute position because cached prefixes are
    page-aligned). Because the scatter covers every row in the batch before
    any row attends, a row may reference prefix pages whose content is written
    by an EARLIER row of the same dispatch (same-wave prefix sharing).

    With ``hist``/``full_tokens [B, F]``/``slot_ids`` (speculative decoding),
    the FULL prompt — cached part included — is recorded into the n-gram
    history buffer and ``(pools, hist)`` is returned.
    """
    b, s_len = tokens.shape
    ps = pools["k"].shape[1]
    assert s_len % ps == 0, (s_len, ps)
    positions = start[:, None] + jnp.arange(s_len, dtype=jnp.int32)[None, :]
    cos, sin = _rope_for_positions(positions, cfg)
    hd = cfg.head_dim
    trash = pools["k"].shape[0] - 1

    h = params["embed"][tokens]  # [B, S, D]
    base_lens = start + 1  # suffix token 0 attends the cached history + itself

    def attend(q, k, v, kp, vp, l):
        # scatter the suffix K/V FIRST, then attend over the gathered page view
        # (cached history + in-suffix predecessors in one joint softmax)
        phys_new = jnp.where(page_ids_new >= n_pages, trash, l * n_pages + page_ids_new).reshape(-1)
        kp = kp.at[phys_new].set(
            k.astype(kp.dtype).reshape(b * s_len // ps, ps, cfg.num_kv_heads * hd)
        )
        vp = vp.at[phys_new].set(
            v.astype(vp.dtype).reshape(b * s_len // ps, ps, cfg.num_kv_heads * hd)
        )
        phys_table = jnp.where(page_table >= n_pages, trash, l * n_pages + page_table)
        attn = paged_attention_multi(q, kp, vp, phys_table, base_lens)
        return attn, kp, vp

    _, kp, vp = _layer_scan(params, cfg, h, pools["k"], pools["v"], cos, sin, attend)
    pools = {"k": kp, "v": vp}
    if hist is None:
        return pools
    hist = hist.at[slot_ids, : full_tokens.shape[1]].set(full_tokens)
    return pools, hist
