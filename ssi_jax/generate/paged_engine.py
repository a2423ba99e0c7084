"""Continuous-batching decode engine over the block-paged KV cache.

Replaces the fixed-batch convoy (``DecodeEngine``: the whole batch waits for its
slowest row, and every (batch, prompt-bucket) pair is a separate compiled
program) with the vLLM-style serving shape the reference leans on
(ref: scripts/generate.py:112-118):

- A fixed pool of ``n_slots`` decode slots advances in lockstep inside ONE
  compiled decode program, whatever mix of prompt/output lengths the slots hold.
- A host-side **scheduler** owns the page free-list: pages are allocated lazily
  (prompt pages at admission, decode pages chunk-by-chunk), freed when a request
  finishes, and new prompts are admitted into freed slots between chunks —
  finished rows never idle the batch.
- Decode runs in chunks of ``chunk`` tokens per dispatch (a ``lax.scan``), so
  host<->device sync happens once per chunk, not per token.
- If the pool runs dry (undersized ``n_pages``), the youngest active request is
  preempted vLLM-style: its pages are freed and it is re-queued for a fresh
  prefill later.

Compiled programs: ONE decode-chunk program + one prefill program per
(prompt bucket, power-of-two group size) — admissions are batched so a group
of G prompts prefills in one dispatch (one weights read instead of G), versus
the dense engine's program per (batch, bucket).

Greedy parity: with ``temperature=0`` the emitted tokens match ``DecodeEngine``
(same attention set, same RoPE positions, same fp32 logits math) — asserted in
tests/test_paged_decode.py.
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ssi_jax.generate.engine import _NEG_INF, SamplingParams
from ssi_jax.generate.paged import (
    decode_step_tokens,
    init_pools,
    prefill_prompts,
    prefill_suffix,
    resolve_decode_impl,
)
from ssi_jax.models.configs import ConfigLlama3_2
from ssi_jax.ops.attention import resolve_attn_impl
from ssi_jax.utils import round_up as _round_up

LOGGER = logging.getLogger(__name__)

# Sampling features a stream's compiled chunk program can carry. Per-REQUEST
# sampling params (the vLLM per-request SamplingParams surface) ride the
# control array as per-slot columns; which BRANCHES exist in the compiled
# program is fixed per stream, so a request never stalls the batch behind a
# mid-stream recompile. A request whose params need a branch the stream did
# not compile is rejected at add_request with a clear error.
SAMPLING_FEATURES = frozenset({"sample", "topk", "topp", "pen"})

# number of host-owned scalar columns at the head of the packed control array:
# [active, admit, admit_seq, admit_tok, admit_budget, prompt_len,
#  temp(f32), top_p(f32), top_k, presence(f32), frequency(f32),
#  repetition(f32), rng_seed] — f32 columns travel bitcast to int32
_N_CTRL_COLS = 13


def _derive_features(sp: SamplingParams) -> frozenset:
    """Minimum feature set a SamplingParams needs from the compiled program.

    top-k/top-p are irrelevant under greedy decoding (argmax is truncation-
    invariant), so a greedy request never requires the sort branch.
    """
    feats = set()
    if sp.temperature != 0.0:
        feats.add("sample")
        if sp.top_k > 0:
            feats.add("topk")
        if sp.top_p < 1.0:
            feats.add("topp")
    if sp.uses_penalties:
        feats.add("pen")
    return frozenset(feats)


def _sample_rows(logits, feats, temp, top_p, top_k, pres, freq, rep, keys,
                 out_counts, prompt_counts):
    """Next token + logprob from [B, V] fp32 logits with PER-ROW sampling params.

    The per-slot generalization of ``engine._sample`` (same penalty scoping and
    logprob point as vLLM: repetition sees prompt+output counts, presence/
    frequency see output counts; logprob from the post-penalty post-temperature
    pre-truncation distribution). ``feats`` is static and decides which branches
    compile; a runtime ``lax.cond`` on "any row actually sampling" keeps
    greedy-only steps at argmax cost even when the sampling branch is compiled
    in — the sort/Gumbel work only executes on steps that need it.

    Rows with ``temp == 0`` take argmax regardless of their top-k/top-p values.
    ``keys`` are per-row PRNG keys (position-keyed by the caller, so a
    preempted-and-recomputed request redraws the identical tokens).
    """
    if "pen" in feats:
        appeared_any = (out_counts + prompt_counts) > 0
        rp = rep[:, None]
        bent = jnp.where(logits > 0, logits / rp, logits * rp)
        logits = jnp.where(appeared_any, bent, logits)
        logits = logits - freq[:, None] * out_counts \
            - pres[:, None] * (out_counts > 0).astype(logits.dtype)
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    lse_raw = jax.nn.logsumexp(logits, axis=-1)
    greedy_lp = jnp.take_along_axis(logits, greedy[:, None], axis=-1)[:, 0] - lse_raw
    if "sample" not in feats:
        return greedy, greedy_lp

    is_samp = temp > 0.0

    def sampled(_):
        lt = logits / jnp.where(is_samp, temp, 1.0)[:, None]
        trunc = lt
        if "topk" in feats or "topp" in feats:
            sorted_desc = jnp.sort(lt, axis=-1)[:, ::-1]
            if "topk" in feats:
                idx = jnp.clip(top_k, 1, lt.shape[-1]) - 1
                kth = jnp.take_along_axis(sorted_desc, idx[:, None], axis=-1)
                kth = jnp.where((top_k > 0)[:, None], kth, -jnp.inf)
                trunc = jnp.where(lt < kth, _NEG_INF, trunc)
            if "topp" in feats:
                probs = jax.nn.softmax(sorted_desc, axis=-1)
                cutoff_idx = jnp.sum(jnp.cumsum(probs, axis=-1) < top_p[:, None], axis=-1)
                cutoff = jnp.take_along_axis(sorted_desc, cutoff_idx[:, None], axis=-1)
                cutoff = jnp.where((top_p < 1.0)[:, None], cutoff, -jnp.inf)
                trunc = jnp.where(lt < cutoff, _NEG_INF, trunc)
        draw = jax.vmap(jax.random.categorical)(keys, trunc).astype(jnp.int32)
        tok = jnp.where(is_samp, draw, greedy)
        lse_t = jax.nn.logsumexp(lt, axis=-1)
        lp = jnp.take_along_axis(lt, tok[:, None], axis=-1)[:, 0] - lse_t
        return tok, jnp.where(is_samp, lp, greedy_lp)

    return jax.lax.cond(jnp.any(is_samp), sampled, lambda _: (greedy, greedy_lp), None)


@dataclass
class _Request:
    idx: int                      # position in the caller's prompt list
    prompt: list[int]
    seq: int = 0                  # sequence index within the prompt (n>1 sampling)
    out: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)  # per-token logprobs (empty in spec mode)
    clp: float = 0.0
    done_reason: str | None = None
    max_tokens: int | None = None  # per-request budget (<= stream sp.max_tokens)
    sampling: SamplingParams | None = None  # per-request override (None = stream sp)
    rng_seed: int = 0             # per-sequence sampling seed (rides the control array)
    requeued: bool = False        # preempted / gang-split work parked at the queue
    # front; sorted admission orders (sjf/ljf) never insert ahead of it


@dataclass
class _Slot:
    req: _Request | None = None
    pages: list[int] = field(default_factory=list)
    seq_len: int = 0              # valid cache tokens (prompt + consumed outputs)
    n_out: int = 0                # tokens emitted so far
    done: bool = False            # hit a stop token / budget; awaiting collection
    cached_len: int = 0           # prompt tokens satisfied by the prefix cache
    fresh: list[int] = field(default_factory=list)  # cache pages registered at
    # this admission whose content is only valid once its prefill dispatches
    # (unregistered on pre-prefill rollback)
    prefilling: bool = False      # chunked prefill in progress (decode gated)
    prefilled: int = 0            # prompt positions with K/V written so far
    hashes: list = field(default_factory=list)  # chain hashes for piece-wise
    # cache registration (chunked slots register pages as pieces dispatch)


@dataclass
class _Stream:
    """Per-stream scheduler state (one active stream per engine; see
    PagedDecodeEngine.begin_stream)."""

    sp: SamplingParams
    key: Any
    use_pen: bool
    stop_set: set
    chunk_fn: Any
    features: frozenset = frozenset()  # compiled sampling branches (see SAMPLING_FEATURES)
    # request lifecycle
    queue: list[list[_Request]] = field(default_factory=list)      # admission groups
    results: dict[tuple[int, int], dict] = field(default_factory=dict)
    expected: dict[int, int] = field(default_factory=dict)         # idx -> n sequences
    collected: dict[int, int] = field(default_factory=dict)        # idx -> sequences done
    completed: deque = field(default_factory=deque)                # idxs ready to return
    next_idx: int = 0
    # in-flight chunk futures (oldest first)
    pending: deque = field(default_factory=deque)
    suspend_admission: bool = False                                # set on self-preemption
    # device carries + host control columns, created by begin_stream
    seq_lens: Any = None
    tok: Any = None
    done: Any = None
    budget: Any = None
    out_counts: Any = None
    active: Any = None
    admit: Any = None
    admit_seq: Any = None
    admit_tok: Any = None
    admit_budget: Any = None
    prompt_lens: Any = None
    prompt_counts: Any = None
    # per-slot sampling columns (host-owned, re-sent with every control array)
    slot_temp: Any = None
    slot_top_p: Any = None
    slot_top_k: Any = None
    slot_pres: Any = None
    slot_freq: Any = None
    slot_rep: Any = None
    slot_seed: Any = None
    hist: Any = None               # [n_slots+1, W+1] token history (speculate_k > 0)
    stats: dict = field(default_factory=dict)
    t_start: float = 0.0


class PagedDecodeEngine:
    """Continuous-batching generation over a paged KV cache.

    Args:
        params: model param pytree.
        cfg: architecture config.
        pad_id: filler token for inactive slots' inputs.
        n_slots: decode slots advanced per step (the "batch").
        page_size: tokens per KV page. The ``"triton"`` decode kernel needs a
            power of two >= 16.
        n_pages: pool size; default sizes for n_slots full contexts
            (prompt bucket + max 1024 outputs) — lazy allocation means typical
            usage touches far fewer.
        prompt_bucket: prefill programs are compiled per multiple of this.
        chunk: decode steps per device dispatch.
        attn_impl: decode attention — "gather" (XLA, anywhere), "triton" (the
            Pallas paged kernel, NVIDIA GPU), or "auto" (by platform:
            ``paged.resolve_decode_impl``).
        prefill_impl: prompt-prefill attention — "xla" (einsum), "cudnn"
            (fused attention, NVIDIA GPU, bf16/fp16), or "auto" (by platform
            and the weights' dtype).
        pipeline_depth: chunks kept in flight before the oldest is BLOCK-harvested
            (1 = harvest immediately after each dispatch). Ready results are
            additionally collected opportunistically every iteration, so deeper
            pipelines no longer idle finished slots. Default 2, which also
            minimizes done-slot latency.
        quantize: None (bf16 weights) or "int8" (weight-only per-channel int8
            for the layer stack — faster decode, not bitwise vs bf16).
        speculate_k: draft length for n-gram speculative decoding (0 = off).
            Greedy-only (temperature 0, no penalties, n=1). Each decode step
            verifies 1 + k candidate tokens in ONE forward — one weights read
            (the dominant HBM cost of decode) can emit up to k+1 tokens when
            the drafter's bigram continuation from the slot's own token
            history matches; outputs are EXACTLY the non-speculative greedy
            outputs (acceptance is argmax equality, the lossless criterion).
            Wins scale with traffic repetitiveness (ASR transcripts: the
            continuation usually lives in the prompt); worst case ~costs the
            extra attention/logits of k rejected candidates per step.
        prefix_caching: reuse KV pages across REQUESTS when prompts share a
            prefix (vLLM's automatic prefix caching). Full prompt pages are
            keyed by a chained hash of their token blocks; an admission whose
            prompt extends a cached chain references those pages by refcount
            and prefills only the uncached tail (``prefill_suffix``) — or
            nothing at all on a full hit. Pages whose last reference drops
            stay cached (LRU) and are evicted only when the free list runs
            dry, so the pool never shrinks. Exact: cached K/V is the K/V a
            fresh prefill would write (same tokens, same absolute positions —
            bitwise under the xla prefill impl; under prefill_impl=cudnn the
            suffix pass still uses the gather path, a low-bit bf16 difference
            of the same order as the impl choice itself). Wins scale with shared-
            prefix traffic (a common system prompt, n>1 resampling, WER evals
            re-running a split); pure-random prompts see no reuse and no cost
            beyond the per-admission hash.
        mesh: optional ``jax.sharding.Mesh`` with a ``"tp"`` axis for
            tensor-parallel serving of models too large for one chip (vLLM's
            ``tensor_parallel_size`` role). Weights shard with training TP's
            ``parallel.param_specs``; KV pools shard along the kv-head
            feature axis; the scheduler is unchanged. Plain XLA attention only
            (gather decode, einsum prefill); validated for output
            equality vs single-device on a virtual mesh
            (tests/test_paged_tp.py).
        prefill_chunk: cap (in tokens, a multiple of ``prompt_bucket``) on the
            prompt span any single prefill dispatch covers — vLLM's chunked
            prefill. A longer prompt is admitted into its slot but its prefill
            is split into pieces dispatched one per scheduler step, each a
            ``prefill_suffix`` pass over the pages written so far, while the
            OTHER slots' decode chunks keep dispatching in between — a long
            arrival no longer stalls the whole batch for its full prefill.
            Decode for the slot starts once all its prompt K/V is written.
            Composes with prefix caching (pieces start at the cached length;
            written pieces register pages as they dispatch, so a preempted or
            aborted long prefill resumes from its cached pages). n>1 gangs
            prefill unchunked (the sibling boundary-page fork needs the final
            prefix content at admission). None = off (whole-bucket prefill at
            admission, today's default).
    """

    def __init__(
        self,
        params: Any,
        cfg: ConfigLlama3_2,
        pad_id: int,
        *,
        n_slots: int = 32,
        page_size: int = 128,
        n_pages: int | None = None,
        max_context: int = 1280,
        prompt_bucket: int = 128,
        chunk: int = 16,
        attn_impl: str = "auto",
        prefill_impl: str = "auto",
        pipeline_depth: int = 2,
        quantize: str | None = None,
        speculate_k: int = 0,
        prefix_caching: bool = True,
        mesh: Any = None,
        prefill_chunk: int | None = None,
        admission_order: str = "fifo",
    ):
        if mesh is not None:
            # Tensor-parallel serving (the vLLM tensor_parallel_size role): the
            # model weights shard with the SAME Megatron-paired specs training
            # TP uses (parallel.param_specs — wq/wk/wv/w_gate/w_up column,
            # wo/w_down row, embed vocab-sharded) and the KV pools shard along
            # the kv-head feature axis, so attention is head-local and each
            # layer needs one psum (wo) + one (w_down), inserted by GSPMD.
            # The host scheduler is unchanged — control arrays replicate.
            # The paged kernel is a single-device program, so TP runs the
            # plain XLA attention paths.
            if quantize is not None:
                raise ValueError(
                    "mesh (tensor-parallel decode) does not compose with quantize: "
                    "the int8 tree carries per-channel scales with no sharding rules yet"
                )
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P

            from ssi_jax.parallel import param_shardings

            params = jax.device_put(params, param_shardings(mesh, params))
            if attn_impl == "auto":
                attn_impl = "gather"
            if prefill_impl == "auto":
                prefill_impl = "xla"
            if attn_impl != "gather":
                raise ValueError(f"mesh (tensor-parallel decode) runs the gather attention, not {attn_impl!r}")
        self.mesh = mesh
        if quantize == "int8":
            # weight-only int8 for the layer stack: halves the dominant HBM
            # traffic of the (weights-bound) decode step; greedy outputs are
            # NOT bitwise vs bf16 (see generate/quant.py)
            from ssi_jax.generate.quant import quantize_layer_weights_int8

            params = quantize_layer_weights_int8(params)
        elif quantize is not None:
            raise ValueError(f"Unknown quantize mode {quantize!r}; expected 'int8' or None")
        self.params = params
        self.cfg = cfg
        self.pad_id = pad_id
        self.n_slots = n_slots
        self.page_size = page_size
        if page_size % 8 != 0 or page_size <= 0:
            # keeps pages aligned for the bucket arithmetic of prompt prefill
            raise ValueError(f"page_size ({page_size}) must be a positive multiple of 8")
        if prompt_bucket % page_size != 0:
            raise ValueError(f"prompt_bucket ({prompt_bucket}) must be a multiple of page_size ({page_size})")
        if prefill_chunk is not None and (prefill_chunk <= 0 or prefill_chunk % prompt_bucket != 0):
            # pieces must start page-aligned (the suffix pass writes whole pages)
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive multiple of "
                f"prompt_bucket ({prompt_bucket})"
            )
        self.prefill_chunk = prefill_chunk
        if admission_order not in ("fifo", "sjf", "ljf"):
            raise ValueError(
                f"Unknown admission_order {admission_order!r}; expected 'fifo', 'sjf', or 'ljf'"
            )
        # Queue discipline for NEW requests (preempted work always re-queues at
        # the front — it holds in-progress tokens). Estimated job size is
        # prompt_len + per-request token budget:
        #   - fifo: arrival order (serving default — no starvation, stable TTFT)
        #   - sjf:  shortest-first — minimizes mean completion time / mean TTFT
        #   - ljf:  longest-first (LPT) — minimizes batch makespan: long jobs
        #     start early so the drain tail (slots emptying with nothing left
        #     to admit) is spent on short work, not the stragglers
        self.admission_order = admission_order
        self.max_context = _round_up(_round_up(max_context, page_size), prompt_bucket)
        self.max_pages_per_seq = self.max_context // page_size
        self.prompt_bucket = prompt_bucket
        self.chunk = chunk
        self.pipeline_depth = max(1, int(pipeline_depth))
        if not 0 <= speculate_k <= 7:
            # bounds the verify pass at 8 candidate tokens per slot
            raise ValueError(f"speculate_k ({speculate_k}) must be in [0, 7]")
        self.speculate_k = int(speculate_k)
        self.attn_impl = resolve_decode_impl(attn_impl)
        cache_dtype = params["embed"].dtype
        self.prefill_impl = resolve_attn_impl(prefill_impl, cache_dtype)
        if n_pages is None:
            n_pages = n_slots * self.max_pages_per_seq
        self.n_pages = n_pages

        self.pools = init_pools(cfg, n_pages, page_size, dtype=cache_dtype)
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P

            kvd = self.pools["k"].shape[2]
            tp = mesh.shape.get("tp", 1)
            spec = _P(None, None, "tp") if kvd % tp == 0 else _P()
            sh = NamedSharding(mesh, spec)
            self.pools = {k: jax.device_put(v, sh) for k, v in self.pools.items()}
        self._free_pages: list[int] = list(range(n_pages))
        # reference counts: n>1 sampling shares a prompt's full read-only pages
        # across its n sequences (vLLM's parallel-sampling memory sharing);
        # a page returns to the free list when its last reference drops
        self._page_refs = np.zeros(n_pages, np.int32)
        # cross-request prefix cache: chain-hash -> logical page (1:1 with the
        # reverse map). A cached page with refcount 0 parks in the LRU instead
        # of the free list; _alloc_pages evicts LRU-first when the list runs dry.
        self.prefix_caching = bool(prefix_caching)
        self._prefix_map: dict[bytes, int] = {}
        self._page_hash: dict[int, bytes] = {}
        self._cache_lru: OrderedDict[int, None] = OrderedDict()
        self._copy_fn_cache: dict[int, Any] = {}
        self._slots = [_Slot() for _ in range(n_slots)]
        # roofline accounting: HBM bytes one weights stream costs (int8 trees
        # count their int8 data + scales — whatever the tree actually holds)
        self._weight_bytes = int(
            sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(self.params))
        )
        # host mirrors of device state
        self._page_table = np.zeros((n_slots, self.max_pages_per_seq), np.int32)
        self._prefill_cache: dict[tuple[int, int], Any] = {}
        self._chunk_fn_cache: dict[Any, Any] = {}
        # per-call scheduler/throughput counters (vLLM exposes the analogous
        # Stats object); refreshed by every generate_batch, cheap host ints only
        self.last_stats: dict[str, Any] = {}

    # --- compiled programs -------------------------------------------------------

    # Prefill group sizes: admissions are batched into one dispatch per
    # (bucket, group) — a group of G prompts costs ONE weights read instead of
    # G. Power-of-two groups bound the compile count.
    PREFILL_GROUPS = (8, 4, 2, 1)

    def _prefill_fn(self, p: int, group: int):
        spec = self.speculate_k > 0
        key = (p, group, spec)
        if key not in self._prefill_cache:
            cfg = self.cfg
            n_pages = self.n_pages
            prefill_impl = self.prefill_impl

            if spec:
                # speculative mode also records prompt tokens into the n-gram
                # history buffer (drafts match against the prompt itself)
                def prefill(params, pools, tokens, page_ids, hist, slot_ids):
                    return prefill_prompts(
                        params, tokens, cfg, pools, page_ids, n_pages=n_pages,
                        prefill_impl=prefill_impl, hist=hist, slot_ids=slot_ids,
                    )

                self._prefill_cache[key] = jax.jit(prefill, donate_argnums=(1, 4))
            else:
                def prefill(params, pools, tokens, page_ids):
                    return prefill_prompts(
                        params, tokens, cfg, pools, page_ids, n_pages=n_pages, prefill_impl=prefill_impl
                    )

                self._prefill_cache[key] = jax.jit(prefill, donate_argnums=(1,))
        return self._prefill_cache[key]

    def _copy_pages_fn(self, m: int):
        """Compiled page copy: duplicate ``m`` logical pages across all layers
        (the n>1 boundary-page fork — the page holding position p-1 is written
        by every sequence from its first decode step, so siblings get a private
        copy while the fully-read-only prefix pages are shared by reference).
        Pad rows point src AND dst at the trash page."""
        if m not in self._copy_fn_cache:
            n_layers = self.cfg.num_layers
            n_pages = self.n_pages
            trash_off = n_layers * n_pages  # physical trash row

            def cp(pools, src, dst):
                offs = jnp.arange(n_layers, dtype=jnp.int32)[:, None] * n_pages
                s = jnp.where(src[None, :] >= n_pages, trash_off, offs + src[None, :]).reshape(-1)
                d = jnp.where(dst[None, :] >= n_pages, trash_off, offs + dst[None, :]).reshape(-1)
                return {"k": pools["k"].at[d].set(pools["k"][s]), "v": pools["v"].at[d].set(pools["v"][s])}

            self._copy_fn_cache[m] = jax.jit(cp, donate_argnums=(0,))
        return self._copy_fn_cache[m]

    def _chunk_fn(self, sp: SamplingParams, feats: frozenset = frozenset()):
        if self.speculate_k > 0:
            return self._chunk_fn_spec(sp)
        cache_key = (sp, feats, self.chunk)
        if cache_key in self._chunk_fn_cache:
            return self._chunk_fn_cache[cache_key]
        cfg = self.cfg
        pad_id = self.pad_id
        attn_impl = self.attn_impl
        stop_ids = jnp.asarray(sp.stop_token_ids, jnp.int32) if sp.stop_token_ids else jnp.zeros((0,), jnp.int32)

        n_pages = self.n_pages

        # ONE packed int32 control array per dispatch carries every host-owned
        # scalar column + the page table: [active | admit | admit_seq_len |
        # admit_tok | admit_budget | prompt_len | per-slot sampling params
        # (f32 cols bitcast) | page_table...]. Admissions are applied INSIDE
        # the compiled program via where-selects instead of several tiny
        # `.at[].set` device dispatches per admitted slot.
        def chunk(params, pools, control, seq_lens, tok, done, budget,
                  out_counts, prompt_counts, key):
            active = control[:, 0] != 0
            admit = control[:, 1] != 0
            seq_lens = jnp.where(admit, control[:, 2], seq_lens)
            tok = jnp.where(admit, control[:, 3], tok)
            budget = jnp.where(admit, control[:, 4], budget)
            prompt_lens = control[:, 5]
            done = jnp.where(admit, False, done)
            if "pen" in feats:
                out_counts = jnp.where(admit[:, None], 0.0, out_counts)
            f32 = lambda col: jax.lax.bitcast_convert_type(control[:, col], jnp.float32)
            temp, top_p, top_k = f32(6), f32(7), control[:, 8]
            pres, freq, rep = f32(9), f32(10), f32(11)
            seed_col = control[:, 12]
            page_table = control[:, _N_CTRL_COLS:]

            def step(carry, _):
                pools, seq_lens, tok, done, budget, out_counts, key, clp = carry
                advance = jnp.logical_and(active, jnp.logical_not(done))
                logits, pools = decode_step_tokens(
                    params, tok, cfg, pools, page_table, seq_lens, advance,
                    n_pages=n_pages, attn_impl=attn_impl,
                )
                if "pen" in feats:
                    # the consumed token is an OUTPUT only once the cache has
                    # grown past the prompt (the first consumed token after
                    # admission is prompt[-1] — vLLM scopes it to prompt counts)
                    is_output = seq_lens >= prompt_lens
                    out_counts = out_counts.at[jnp.arange(tok.shape[0]), tok].add(
                        jnp.where(jnp.logical_and(advance, is_output), 1.0, 0.0)
                    )
                keys = None
                if "sample" in feats:
                    # position-keyed per-row PRNG: (stream key, request seed,
                    # absolute position) — independent of scheduling, so a
                    # preempted request's recompute redraws identical tokens
                    # and the streamed prefix never diverges
                    keys = jax.vmap(
                        lambda s, p: jax.random.fold_in(jax.random.fold_in(key, s), p)
                    )(seed_col, seq_lens)
                next_tok, lp = _sample_rows(
                    logits, feats, temp, top_p, top_k, pres, freq, rep, keys,
                    out_counts, prompt_counts,
                )
                clp = clp + jnp.where(advance, lp, 0.0)
                seq_lens = seq_lens + advance.astype(seq_lens.dtype)
                budget = budget - advance.astype(budget.dtype)
                is_stop = jnp.isin(next_tok, stop_ids) if stop_ids.size else jnp.zeros_like(done)
                newly_done = jnp.logical_and(advance, jnp.logical_or(is_stop, budget <= 0))
                emitted = jnp.where(advance, next_tok, pad_id)
                done = jnp.logical_or(done, newly_done)
                next_tok = jnp.where(advance, next_tok, tok)
                lp_step = jnp.where(advance, lp, 0.0)
                return (pools, seq_lens, next_tok, done, budget, out_counts, key, clp), (emitted, lp_step)

            clp0 = jnp.zeros(tok.shape, jnp.float32)
            (pools, seq_lens, tok, done, budget, out_counts, key, clp), (emitted, lps) = jax.lax.scan(
                step, (pools, seq_lens, tok, done, budget, out_counts, key, clp0), None,
                length=self.chunk,
            )
            # Harvest view packed into ONE int32 array [slots, 2*chunk+3]: the
            # per-harvest device_get is a single transfer, not one per array:
            # columns are
            # [emitted tokens | per-token logprobs bitcast | done flag |
            #  seq_len | clp bitcast to int32].
            packed = jnp.concatenate(
                [
                    emitted.T,
                    jax.lax.bitcast_convert_type(lps.T, jnp.int32),
                    done.astype(jnp.int32)[:, None],
                    seq_lens[:, None],
                    jax.lax.bitcast_convert_type(clp, jnp.int32)[:, None],
                ],
                axis=1,
            )
            return pools, seq_lens, tok, done, budget, out_counts, key, packed

        fn = jax.jit(chunk, donate_argnums=(1,))
        self._chunk_fn_cache[cache_key] = fn
        return fn

    def _chunk_fn_spec(self, sp: SamplingParams):
        """Speculative decode-chunk program: each scan step drafts k candidate
        continuations per slot from its own token history (most recent bigram
        match — "prompt lookup" n-gram speculation), verifies all k+1 tokens
        in ONE forward, and emits the longest argmax-matching prefix + one.
        Greedy outputs are EXACTLY the non-speculative stream (lossless).

        Signature differs from the base chunk: carries the history buffer
        ``hist [n_slots+1, W+1]`` (trash row for pad prefill rows, trash
        column for masked scatters) instead of penalty state."""
        cache_key = (sp, self.chunk, self.speculate_k)
        if cache_key in self._chunk_fn_cache:
            return self._chunk_fn_cache[cache_key]
        cfg = self.cfg
        pad_id = self.pad_id
        stop_ids = jnp.asarray(sp.stop_token_ids, jnp.int32) if sp.stop_token_ids else jnp.zeros((0,), jnp.int32)
        n_pages = self.n_pages
        t_q = self.speculate_k + 1
        w = self.max_context
        bucket = self.prompt_bucket
        n_chunk = self.chunk

        from ssi_jax.generate.paged import decode_step_tokens_spec

        def chunk(params, pools, control, seq_lens, tok, done, budget, hist, key):
            active = control[:, 0] != 0
            admit = control[:, 1] != 0
            seq_lens = jnp.where(admit, control[:, 2], seq_lens)
            tok = jnp.where(admit, control[:, 3], tok)
            budget = jnp.where(admit, control[:, 4], budget)
            prompt_lens = control[:, 5]
            done = jnp.where(admit, False, done)
            # speculative streams are greedy-only: sampling columns 6:13 unused
            page_table = control[:, _N_CTRL_COLS:]
            # Per-slot hard write bound, mirroring the host's page provisioning
            # cap (step(): max(round_up(prompt, bucket), prompt + req.max_tokens)):
            # candidates at/beyond it land on the trash page. The PER-REQUEST
            # budget must be used — a request admitted with max_tokens below the
            # stream's gets fewer pages provisioned, and a stream-level cap here
            # would let draft K/V write through stale page-table entries into
            # pages owned by other live requests. seq_lens + budget is invariant
            # across spec steps (+n_emit / -n_emit), and at admission
            # seq_lens = prompt - 1, budget = req.max_tokens, so
            # prompt + req.max_tokens == seq_lens + budget + 1 at every step.
            cap = jnp.minimum(
                jnp.maximum(((prompt_lens + bucket - 1) // bucket) * bucket, seq_lens + budget + 1), w
            )
            n_slots = tok.shape[0]
            rows = jnp.arange(n_slots)
            iota_t = jnp.arange(t_q, dtype=jnp.int32)
            buf_w = n_chunk * t_q + 1  # +1 trash column for masked scatters

            def step(carry, _):
                pools, seq_lens, tok, done, budget, hist, out_buf, cursor, clp, nstep = carry
                advance = jnp.logical_and(active, jnp.logical_not(done))
                nstep = nstep + advance.astype(jnp.int32)
                length = seq_lens  # position of the input token
                # ---- n-gram draft: most recent bigram match in own history
                histw = hist[:n_slots, :w]  # drop the trash row + trash column
                b0 = histw[rows, jnp.clip(length - 1, 0, w - 1)]
                posj = jnp.arange(w - 1, dtype=jnp.int32)
                can = (
                    (histw[:, :-1] == b0[:, None])
                    & (histw[:, 1:] == tok[:, None])
                    & ((posj + 1)[None, :] < length[:, None])
                    & (length[:, None] >= 2)
                )
                jbest = jnp.max(jnp.where(can, posj[None, :], -1), axis=1)
                found = jbest >= 0
                gidx = jnp.clip(jbest[:, None] + 1 + iota_t[None, :], 0, w - 1)
                cont = jnp.take_along_axis(histw, gidx, axis=1)  # [slots, T]
                draft = jnp.concatenate(
                    [tok[:, None], jnp.where(found[:, None], cont[:, 1:], pad_id)], axis=1
                )
                # ---- verify all T candidates in one forward
                logits, pools = decode_step_tokens_spec(
                    params, draft, cfg, pools, page_table, seq_lens, advance, cap,
                    n_pages=n_pages,
                )
                out = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [slots, T]
                lse = jax.nn.logsumexp(logits, axis=-1)
                lp = jnp.take_along_axis(logits, out[..., None], axis=-1)[..., 0] - lse
                # ---- accept the longest matching prefix (+ the bonus token)
                match = draft[:, 1:] == out[:, :-1]
                accepted = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)
                n_full = jnp.minimum(1 + accepted, budget)
                is_stop = jnp.isin(out, stop_ids) if stop_ids.size else jnp.zeros(out.shape, bool)
                cand = jnp.logical_and(is_stop, iota_t[None, :] < n_full[:, None])
                stop_j = jnp.min(jnp.where(cand, iota_t[None, :], t_q), axis=1)
                stopped = stop_j < t_q
                n_emit = jnp.where(stopped, stop_j + 1, n_full)
                n_emit = jnp.where(advance, n_emit, 0)
                newly_done = jnp.logical_and(advance, jnp.logical_or(stopped, budget - n_emit <= 0))
                emit = iota_t[None, :] < n_emit[:, None]
                # compact emitted tokens at each slot's cursor (masked -> trash col)
                bidx = jnp.where(emit, cursor[:, None] + iota_t[None, :], buf_w - 1)
                out_buf = out_buf.at[rows[:, None], bidx].set(jnp.where(emit, out, pad_id))
                # emitted token j becomes position length+1+j of the history
                hidx = jnp.where(emit, jnp.clip(length[:, None] + 1 + iota_t[None, :], 0, w), w)
                hist = hist.at[rows[:, None], hidx].set(jnp.where(emit, out, 0))
                cursor = cursor + n_emit
                clp = clp + jnp.sum(jnp.where(jnp.logical_and(emit, advance[:, None]), lp, 0.0), axis=1)
                seq_lens = seq_lens + n_emit
                budget = budget - n_emit
                last = jnp.clip(n_emit - 1, 0, t_q - 1)
                tok = jnp.where(
                    jnp.logical_and(advance, n_emit > 0),
                    jnp.take_along_axis(out, last[:, None], axis=1)[:, 0],
                    tok,
                )
                done = jnp.logical_or(done, newly_done)
                return (pools, seq_lens, tok, done, budget, hist, out_buf, cursor, clp, nstep), None

            out_buf0 = jnp.full((n_slots, buf_w), pad_id, jnp.int32)
            cursor0 = jnp.zeros((n_slots,), jnp.int32)
            clp0 = jnp.zeros((n_slots,), jnp.float32)
            nstep0 = jnp.zeros((n_slots,), jnp.int32)
            (pools, seq_lens, tok, done, budget, hist, out_buf, cursor, clp, nstep), _ = jax.lax.scan(
                step, (pools, seq_lens, tok, done, budget, hist, out_buf0, cursor0, clp0, nstep0), None,
                length=n_chunk,
            )
            packed = jnp.concatenate(
                [
                    out_buf[:, : n_chunk * t_q],
                    done.astype(jnp.int32)[:, None],
                    seq_lens[:, None],
                    jax.lax.bitcast_convert_type(clp, jnp.int32)[:, None],
                    nstep[:, None],  # spec-only 4th tail column: verify steps
                ],
                axis=1,
            )
            return pools, seq_lens, tok, done, budget, hist, key, packed

        fn = jax.jit(chunk, donate_argnums=(1, 7))
        self._chunk_fn_cache[cache_key] = fn
        return fn

    # --- host-side page scheduling -------------------------------------------------

    def _alloc_pages(self, n: int) -> list[int] | None:
        # top up from the prefix cache's unreferenced pages (LRU first) before
        # reporting the pool dry — cached pages are reclaimable capacity
        while len(self._free_pages) < n and self._cache_lru:
            pg, _ = self._cache_lru.popitem(last=False)
            self._prefix_map.pop(self._page_hash.pop(pg), None)
            self._free_pages.append(pg)
        if len(self._free_pages) < n:
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._page_refs[p] = 1
        return pages

    def _share_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._page_refs[p] += 1

    def _release_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                if p in self._page_hash:  # keep cached content around, evictable
                    self._cache_lru[p] = None
                    self._cache_lru.move_to_end(p)
                else:
                    self._free_pages.append(p)

    def _unregister_pages(self, pages: list[int]) -> None:
        """Drop pages from the prefix cache (pre-prefill rollback: their
        content was never written). Refcounts are untouched — the caller's
        _free_slot routes them to the free list since the hash entry is gone."""
        for p in pages:
            h = self._page_hash.pop(p, None)
            if h is not None:
                self._prefix_map.pop(h, None)
            self._cache_lru.pop(p, None)

    def _free_slot(self, slot: _Slot):
        self._release_pages(slot.pages)
        slot.pages = []
        slot.req = None
        slot.seq_len = 0
        slot.n_out = 0
        slot.done = False
        slot.cached_len = 0
        slot.fresh = []
        slot.prefilling = False
        slot.prefilled = 0
        slot.hashes = []

    def _pages_needed(self, length: int) -> int:
        return -(-length // self.page_size)

    def _match_prefix(self, prompt: list[int]) -> tuple[list[int], list[bytes]]:
        """Longest cached page-chain prefix of ``prompt``. Returns (matched
        logical pages, chain hashes of ALL full prompt pages). Only pages
        holding exclusively positions <= len(prompt)-2 are cacheable — the
        page holding position p-1 is written by the first decode step."""
        ps = self.page_size
        shared_n = (len(prompt) - 1) // ps
        hashes: list[bytes] = []
        h = b""
        arr = np.asarray(prompt[: shared_n * ps], np.int32)
        for i in range(shared_n):
            h = hashlib.sha1(h + arr[i * ps : (i + 1) * ps].tobytes()).digest()
            hashes.append(h)
        matched: list[int] = []
        for h in hashes:
            pg = self._prefix_map.get(h)
            if pg is None:
                break
            matched.append(pg)
        return matched, hashes

    def _clear_prefix_cache(self) -> None:
        """Invalidate the whole prefix cache (stream teardown on error: an
        admitted-but-never-prefilled slot may have registered pages whose
        content was never written). Unreferenced cached pages rejoin the free
        list; referenced ones follow when their last holder releases."""
        self._prefix_map.clear()
        self._page_hash.clear()
        self._free_pages.extend(self._cache_lru)
        self._cache_lru.clear()

    def _ensure_capacity(self, slot_id: int, target_len: int) -> bool:
        """Lazily extend a slot's page list to cover ``target_len`` tokens."""
        slot = self._slots[slot_id]
        need = self._pages_needed(target_len)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"Sequence needs {target_len} tokens > max_context {self.max_context}; "
                f"raise max_context"
            )
        while len(slot.pages) < need:
            got = self._alloc_pages(1)
            if got is None:
                return False
            slot.pages.extend(got)
            self._page_table[slot_id, len(slot.pages) - 1] = got[0]
        return True

    def _preempt_youngest(self, queue: list[list[_Request]]) -> int | None:
        """Free the youngest active unfinished slot, re-queueing its request
        (as a singleton group — a preempted n>1 sibling re-prefills solo).

        Returns the victim slot id (the caller must clear its ``active`` flag
        so the in-flight decode mask stops advancing it), or None if nothing
        is preemptible."""
        candidates = [
            (s.n_out, i) for i, s in enumerate(self._slots) if s.req is not None and not s.done
        ]
        if not candidates:
            return None
        _, victim = min(candidates)
        slot = self._slots[victim]
        LOGGER.warning(
            f"KV pool exhausted: preempting slot {victim} (request {slot.req.idx}, "
            f"{slot.n_out} tokens generated) for recompute-style retry"
        )
        slot.req.out = []
        slot.req.lps = []
        slot.req.clp = 0.0
        slot.req.requeued = True
        queue.insert(0, [slot.req])
        self._free_slot(slot)
        return victim

    # --- main loop -------------------------------------------------------------------

    # --- incremental serving API --------------------------------------------------
    #
    # The engine is a STREAM scheduler (vLLM's LLMEngine shape): begin_stream()
    # pins a SamplingParams + compiled chunk program, add_request() enqueues
    # prompts at any time (including between step() calls — continuous batching
    # with dynamic arrivals), step() runs ONE scheduler iteration (harvest ready
    # results, admit, provision pages, dispatch one chunk) and returns the
    # requests that completed. generate_batch() is a thin driver over these.

    def begin_stream(
        self,
        sp: SamplingParams,
        key: jax.Array | None = None,
        features: Any = None,
    ) -> None:
        """Open a request stream under one default SamplingParams. Exactly one
        stream may be active at a time — the KV pool and slot set are
        engine-level resources.

        ``features`` (iterable of SAMPLING_FEATURES names) decides which
        sampling branches the stream's ONE compiled chunk program carries;
        default = exactly what ``sp`` itself needs. Per-request SamplingParams
        (``add_request(sampling=...)``) may use any compiled-in feature — a
        serving stream typically compiles {"sample","topk","topp"} up front so
        OpenAI-style per-request temperature/top_p/top_k/seed work without a
        mid-stream recompile. Greedy-only
        steps skip the sampling work at runtime (lax.cond), so unused compiled
        branches cost nothing per step; the exception is "pen", whose
        [n_slots, vocab] count arrays ride every dispatch — leave it off
        unless penalties are actually served."""
        if getattr(self, "_st", None) is not None:
            raise RuntimeError("A stream is already active on this engine; call end_stream() first")
        if any(s.req is not None for s in self._slots):
            raise RuntimeError("Engine slots are not free; a previous stream did not clean up")
        if sp.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if sp.n < 1:
            raise ValueError("sampling_params.n must be >= 1")
        if sp.n > self.n_slots:
            raise ValueError(f"sampling_params.n ({sp.n}) cannot exceed n_slots ({self.n_slots})")
        feats = frozenset(features) if features is not None else frozenset()
        unknown = feats - SAMPLING_FEATURES
        if unknown:
            raise ValueError(f"Unknown sampling features {sorted(unknown)}; valid: {sorted(SAMPLING_FEATURES)}")
        feats |= _derive_features(sp)
        if self.speculate_k > 0:
            # lossless speculation is defined by argmax-equality — greedy only;
            # n>1 page sharing would also need history-row forking (future work)
            if sp.temperature != 0.0:
                raise ValueError("speculate_k > 0 requires greedy decoding (temperature=0)")
            if sp.uses_penalties:
                raise ValueError("speculate_k > 0 does not compose with repetition/presence/frequency penalties")
            if sp.n != 1:
                raise ValueError("speculate_k > 0 requires sampling_params.n == 1")
            if feats:
                raise ValueError("speculate_k > 0 streams are greedy-only; no sampling features")
        st = _Stream(
            sp=sp,
            key=key if key is not None else jax.random.key(0),
            use_pen="pen" in feats,
            stop_set=set(sp.stop_token_ids),
            chunk_fn=self._chunk_fn(sp, feats),
            features=feats,
        )
        n = self.n_slots
        v = self.cfg.vocab_size
        # Device-resident slot state (seq_lens/tok/done/budget/out_counts ride
        # the chunk program); everything the HOST owns — active flags, pending
        # admission overrides, prompt lengths, page table — travels as columns
        # of ONE packed int32 control array per dispatch. Admission seeds a
        # slot at seq_len = p - 1 with tok = prompt[-1]: the first chunk step
        # recomputes the last prompt position's K/V in place (same math as the
        # prefill, one redundant token of work) and samples the first output ON
        # DEVICE — admission performs zero host<->device round trips.
        st.seq_lens = jnp.zeros((n,), jnp.int32)
        st.tok = jnp.full((n,), self.pad_id, jnp.int32)
        st.done = jnp.zeros((n,), bool)
        st.budget = jnp.zeros((n,), jnp.int32)
        st.active = np.zeros((n,), bool)
        st.admit = np.zeros((n,), np.int32)
        st.admit_seq = np.zeros((n,), np.int32)
        st.admit_tok = np.zeros((n,), np.int32)
        st.admit_budget = np.zeros((n,), np.int32)
        st.prompt_lens = np.zeros((n,), np.int32)
        st.out_counts = jnp.zeros((n, v) if st.use_pen else (1, 1), jnp.float32)
        st.prompt_counts = np.zeros((n, v) if st.use_pen else (1, 1), np.float32)
        # per-slot sampling columns (defaults = greedy); the f32 ones travel
        # bitcast to int32 inside the packed control array
        st.slot_temp = np.zeros((n,), np.float32)
        st.slot_top_p = np.ones((n,), np.float32)
        st.slot_top_k = np.full((n,), -1, np.int32)
        st.slot_pres = np.zeros((n,), np.float32)
        st.slot_freq = np.zeros((n,), np.float32)
        st.slot_rep = np.ones((n,), np.float32)
        st.slot_seed = np.zeros((n,), np.int32)
        if self.speculate_k > 0:
            # n-gram history: row n_slots = trash (pad prefill rows), column
            # max_context = trash (masked emit scatters)
            st.hist = jnp.zeros((n + 1, self.max_context + 1), jnp.int32)
        st.stats = self.last_stats = {
            "chunk_dispatches": 0,
            "slot_chunks": 0,          # sum over dispatches of runnable slots
            "prefill_dispatches": 0,
            "prefill_rows": 0,
            "prefill_pieces": 0,       # chunked-prefill piece dispatches (rows)
            "prefill_token_area": 0,   # sum of group * bucket (padded work)
            "prompt_tokens": 0,
            "tokens_out": 0,
            "preemptions": 0,
            "pages_shared": 0,         # prefix pages referenced instead of copied (n>1)
            "cached_prompt_tokens": 0,  # prompt tokens served from the prefix cache
            "dispatch_block_s": 0.0,   # host-blocking part of async chunk dispatches
            "prefill_block_s": 0.0,
            "harvest_block_s": 0.0,    # blocked in device_get for chunk results
            "verify_steps": 0,         # spec mode: advancing verify forwards
            "kv_bytes": 0.0,           # roofline: KV page bytes decode chunks DMA
            "weight_bytes": 0.0,       # roofline: weight bytes streamed (decode + prefill)
            "wall_s": 0.0,
        }
        st.t_start = time.perf_counter()
        self._st = st

    def add_request(
        self,
        prompt: list[int],
        max_tokens: int | None = None,
        sampling: SamplingParams | None = None,
        seed: int | None = None,
    ) -> int:
        """Enqueue one prompt on the active stream; returns its request id.
        The request's n sequences are queued as a gang (shared prefix pages).
        Callable at any point in the stream — new arrivals are admitted into
        slots as they free up.

        ``max_tokens`` optionally caps THIS request below the stream's
        ``sp.max_tokens`` (the serving endpoint's per-request budget — the
        compiled program is shared, the budget rides the control array).

        ``sampling`` overrides the stream's SamplingParams for THIS request
        (vLLM's per-request params): temperature/top_p/top_k/penalties/n ride
        the control array as per-slot columns, so mixed greedy-and-sampled
        traffic shares the one compiled program. Each override field must be
        covered by the stream's compiled ``features`` (begin_stream) or the
        request is rejected here. ``sampling.stop_token_ids`` is ignored —
        stop tokens are stream-level (compiled constants). If ``max_tokens``
        is not given, ``sampling.max_tokens`` (when it differs from the
        stream's) is used as the per-request budget.

        ``seed`` makes THIS request's sampling reproducible: outputs are a
        pure function of (stream key, seed, position) — same seed, same
        prompt, same stream key => same tokens, independent of batch
        composition, admission order, or preemption. Unseeded requests draw
        from their request id (deterministic within a stream, fresh across
        re-submissions)."""
        st = self._require_stream()
        sp = st.sp
        esp = sampling if sampling is not None else sp
        if sampling is not None:
            missing = _derive_features(sampling) - st.features
            if missing:
                raise ValueError(
                    f"Per-request sampling needs features {sorted(missing)} not compiled "
                    f"into this stream (features={sorted(st.features)}); pass them to "
                    f"begin_stream(features=...) up front"
                )
            if not 1 <= sampling.n <= self.n_slots:
                raise ValueError(f"sampling.n ({sampling.n}) must be in [1, n_slots = {self.n_slots}]")
            if self.speculate_k > 0 and (sampling.temperature != 0.0 or sampling.uses_penalties or sampling.n != 1):
                raise ValueError("speculate_k > 0 streams are greedy-only; per-request sampling unavailable")
            if max_tokens is None and sampling.max_tokens != sp.max_tokens:
                max_tokens = sampling.max_tokens
        if max_tokens is not None and not 1 <= max_tokens <= sp.max_tokens:
            raise ValueError(
                f"Per-request max_tokens ({max_tokens}) must be in [1, stream "
                f"max_tokens = {sp.max_tokens}] (one compiled program per stream)"
            )
        mt = max_tokens if max_tokens is not None else sp.max_tokens
        if len(prompt) == 0:
            raise ValueError("Prompt is empty")
        if len(prompt) + mt > self.max_context:
            raise ValueError(
                f"Prompt ({len(prompt)} tokens) + max_tokens ({mt}) exceeds "
                f"max_context ({self.max_context})"
            )
        # reject unservable requests upfront: an admission/preemption cycle
        # can never free more than the whole pool
        need = self._pages_needed(max(_round_up(len(prompt), self.prompt_bucket), len(prompt) + mt))
        if need > self.n_pages:
            raise RuntimeError(
                f"KV page pool too small for this prompt: needs {need} pages "
                f"(prompt {len(prompt)} + max_tokens {mt}), pool has {self.n_pages}"
            )
        idx = st.next_idx
        st.next_idx += 1
        # per-sequence PRNG seed: mix (request seed | request id) with the
        # sequence index so n>1 siblings draw independent samples
        base_seed = seed if seed is not None else (42831 + idx)
        # the queue holds GROUPS: the n sequences of a prompt admit together so
        # they can share prefix pages; preempted/split members re-queue solo
        self._queue_insert(st, [
            _Request(
                idx=idx, prompt=list(prompt), seq=j, max_tokens=max_tokens,
                sampling=sampling,
                rng_seed=(base_seed * 1000003 + j * 7919) & 0x7FFFFFFF,
            )
            for j in range(esp.n)
        ])
        st.expected[idx] = esp.n
        st.stats["prompt_tokens"] += len(prompt)
        return idx

    def _job_estimate(self, req: _Request, sp: SamplingParams) -> int:
        """Estimated total job size in tokens: prompt + per-request budget."""
        mt = req.max_tokens if req.max_tokens is not None else sp.max_tokens
        return len(req.prompt) + mt

    def _queue_insert(self, st: "_Stream", group: list[_Request]) -> None:
        """Place a NEW group per the admission order. fifo appends; sjf/ljf
        insert sorted by estimated job size (stable — ties keep arrival order),
        never ahead of requeued (preempted / gang-split) work at the front."""
        if self.admission_order == "fifo":
            st.queue.append(group)
            return
        sign = 1 if self.admission_order == "sjf" else -1
        key = sign * self._job_estimate(group[0], st.sp)
        i = 0
        while i < len(st.queue) and (
            st.queue[i][0].requeued or sign * self._job_estimate(st.queue[i][0], st.sp) <= key
        ):
            i += 1
        st.queue.insert(i, group)

    def cancel_request(
        self,
        request_id: int,
        *,
        keep_tokens: int | None = None,
        finish_reason: str = "abort",
    ) -> bool:
        """Host-side early termination of one request (vLLM's ``abort_request``
        role): every sequence of ``request_id`` — queued or running — is
        finalized immediately with ``finish_reason``, its slots/pages freed.
        ``keep_tokens`` truncates each sequence's output (the serving layer's
        stop-string cut). The completed record surfaces from the next
        ``step()`` like any other finish. Returns False if no live sequence
        matched (already completed or unknown id).

        Freeing mid-flight is safe without draining the pipeline: dispatched
        chunks run in program order, so any write a stale chunk makes to a
        freed page lands BEFORE the page's next occupant writes it, and a
        reader only ever reads positions it wrote itself later. Harvests of
        stale chunks are identity-checked (``s.req is not req_snapshot``) or
        gated on ``s.done``, so no tokens are double-counted."""
        st = self._require_stream()
        found = False
        # queued, not-yet-admitted sequences: finalize with what they have (an
        # un-admitted sequence has no output; a preempted re-queued one is
        # recompute-pending, i.e. also empty)
        kept_groups: list[list[_Request]] = []
        for group in st.queue:
            keep = [r for r in group if r.idx != request_id]
            for r in group:
                if r.idx == request_id:
                    found = True
                    st.results[r.idx, r.seq] = {
                        "token_ids": [], "finish_reason": finish_reason,
                        "stop_reason": None, "cumulative_logprob": 0.0,
                        "logprobs": None,
                    }
                    st.collected[r.idx] = st.collected.get(r.idx, 0) + 1
                    if st.collected[r.idx] == st.expected[r.idx]:
                        st.completed.append(r.idx)
            if keep:
                kept_groups.append(keep)
        st.queue[:] = kept_groups
        # running slots: stop future advancement, skip in-flight harvests
        # (s.done), and collect with the truncation/reason overrides
        for sid, s in enumerate(self._slots):
            if s.req is not None and s.req.idx == request_id and not s.done:
                found = True
                st.active[sid] = False
                st.admit[sid] = 0
                s.done = True
                self._collect(sid, keep_tokens=keep_tokens, finish_reason=finish_reason)
        return found

    @property
    def stream_idle(self) -> bool:
        """True when the active stream has no queued or running requests."""
        st = self._require_stream()
        return not st.queue and all(s.req is None for s in self._slots)

    def end_stream(self) -> None:
        """Close the stream: finalize stats; if requests are still queued or
        running, abandon them and release every slot/page (abort semantics)."""
        st = getattr(self, "_st", None)
        if st is None:
            return
        st.stats["wall_s"] = time.perf_counter() - st.t_start
        cap = st.stats["chunk_dispatches"] * self.n_slots * self.chunk * (self.speculate_k + 1)
        st.stats["slot_occupancy"] = st.stats["tokens_out"] / cap if cap else 0.0
        if self.speculate_k > 0:
            # mean emitted tokens per verify forward (1.0 = speculation never
            # accepted anything; upper bound = speculate_k + 1)
            vs = st.stats["verify_steps"]
            st.stats["tokens_per_verify"] = st.stats["tokens_out"] / vs if vs else 0.0
        # Release every claimed slot/page so the engine survives an aborted
        # stream without a permanently shrunken free list. In-flight device
        # chunks finish against the device-side state they captured and their
        # results are dropped.
        for slot in self._slots:
            if slot.req is not None:
                self._free_slot(slot)
        st.pending.clear()
        self._st = None

    def _require_stream(self) -> "_Stream":
        st = getattr(self, "_st", None)
        if st is None:
            raise RuntimeError("No active stream; call begin_stream(sp) first")
        return st

    # --- per-stream scheduler mechanics ---------------------------------------------

    def _admit_slot(
        self,
        slot_id: int,
        req: _Request,
        shared_prefix: list[int] | None = None,
        solo: bool = True,
    ) -> tuple[int, int] | None:
        """Claim pages + host slot state; returns (slot_id, bucket) for the
        batched prefill pass, or None when the pool is tight. Pure host
        bookkeeping: the admission override rides the next dispatched
        chunk's control array (no device ops here). ``solo`` is False for a
        gang leader (n>1): its prefill must not chunk, because the sibling
        boundary-page fork needs the final prefix content at admission."""
        st = self._st
        p = len(req.prompt)
        p_bucket = _round_up(p, self.prompt_bucket)
        slot = self._slots[slot_id]
        # per-slot sampling columns: host-owned and re-sent with every control
        # array, so setting them here covers both the immediate-admit and the
        # chunked-prefill (deferred admit) paths
        esp = req.sampling if req.sampling is not None else st.sp
        st.slot_temp[slot_id] = esp.temperature
        st.slot_top_p[slot_id] = esp.top_p
        st.slot_top_k[slot_id] = esp.top_k
        st.slot_pres[slot_id] = esp.presence_penalty
        st.slot_freq[slot_id] = esp.frequency_penalty
        st.slot_rep[slot_id] = esp.repetition_penalty
        st.slot_seed[slot_id] = req.rng_seed
        hashes: list[bytes] = []
        if shared_prefix:
            # n>1 sibling: reference the leader's read-only prompt pages,
            # own pages for the rest of the bucket (boundary page onward)
            self._share_pages(shared_prefix)
            slot.pages = list(shared_prefix)
            for k in range(len(shared_prefix)):
                self._page_table[slot_id, k] = shared_prefix[k]
            st.stats["pages_shared"] += len(shared_prefix)
        elif self.prefix_caching:
            # cross-request reuse: reference the longest cached page chain
            # this prompt extends; only the tail past it needs prefilling
            matched, hashes = self._match_prefix(req.prompt)
            for pg in matched:
                self._page_refs[pg] += 1
                if self._page_refs[pg] == 1:
                    self._cache_lru.pop(pg, None)  # back in active use
            slot.pages = list(matched)
            for k in range(len(matched)):
                self._page_table[slot_id, k] = matched[k]
            slot.cached_len = len(matched) * self.page_size
            st.stats["cached_prompt_tokens"] += slot.cached_len
        target = p_bucket
        if 0 < slot.cached_len < p - 1:
            # the suffix pass spans [cached_len, cached_len + suffix bucket);
            # cached_len is page- but not necessarily prompt_bucket-aligned,
            # so the rounded span can overhang p_bucket by < one bucket
            s_bucket = _round_up(p - slot.cached_len, self.prompt_bucket)
            target = min(
                max(p_bucket, slot.cached_len + s_bucket),
                self.max_pages_per_seq * self.page_size,
            )
        if not self._ensure_capacity(slot_id, target):
            # release the partial allocation: a req=None slot is invisible
            # to preemption/collect, so stranded pages would otherwise
            # shrink the pool for the rest of the engine's lifetime
            self._free_slot(slot)
            return None
        chunked = (
            self.prefill_chunk is not None
            and shared_prefix is None
            and solo
            and (p - 1) - slot.cached_len > self.prefill_chunk
        )
        if hashes and not chunked:
            # register this prompt's remaining full pages: valid the moment
            # this round's prefill dispatches; unregistered on group rollback
            # (slot.fresh). Same-wave admissions may match them immediately —
            # _prefill_admitted orders dispatches so writers precede readers.
            fresh = []
            for i in range(slot.cached_len // self.page_size, len(hashes)):
                pg = slot.pages[i]
                self._prefix_map[hashes[i]] = pg
                self._page_hash[pg] = hashes[i]
                fresh.append(pg)
            slot.fresh = fresh
        slot.req = req
        slot.seq_len = p - 1
        slot.n_out = 0
        slot.done = False

        if chunked:
            # decode is gated until every prompt position < p-1 has K/V;
            # pieces dispatch one per step (_advance_prefills). Pages register
            # into the prefix cache piece-by-piece as their content is written.
            slot.prefilling = True
            slot.prefilled = slot.cached_len
            slot.hashes = hashes
            return slot_id, p_bucket

        if st.use_pen:
            cnt = np.zeros((self.cfg.vocab_size,), np.float32)
            np.add.at(cnt, req.prompt, 1.0)
            st.prompt_counts[slot_id] = cnt

        st.active[slot_id] = True
        st.admit[slot_id] = 1
        st.admit_seq[slot_id] = p - 1
        st.admit_tok[slot_id] = req.prompt[-1]
        st.admit_budget[slot_id] = req.max_tokens if req.max_tokens is not None else st.sp.max_tokens
        st.prompt_lens[slot_id] = p
        return slot_id, p_bucket

    def _admit_group(self, group: list[_Request], slot_ids: list[int]):
        """Admit a prompt's sequences together: the leader prefills; each
        sibling shares the leader's full read-only pages and receives a
        device-side copy of the boundary page. Returns (prefill claim,
        boundary copies) or None (pool tight — everything rolled back)."""
        st = self._st
        leader, siblings = group[0], group[1:]
        claim = self._admit_slot(slot_ids[0], leader, solo=len(group) == 1)
        if claim is None:
            return None
        admitted_ids = [slot_ids[0]]
        copies: list[tuple[int, int]] = []
        p = len(leader.prompt)
        shared_n = (p - 1) // self.page_size  # pages holding only positions <= p-2
        lead_pages = self._slots[slot_ids[0]].pages
        for sid, req in zip(slot_ids[1:], siblings):
            got = self._admit_slot(sid, req, shared_prefix=lead_pages[:shared_n])
            if got is None:
                for aid in admitted_ids:  # roll the whole group back
                    # drop cache registrations whose prefill will never run
                    self._unregister_pages(self._slots[aid].fresh)
                    self._free_slot(self._slots[aid])
                    st.active[aid] = False
                    st.admit[aid] = 0
                return None
            admitted_ids.append(sid)
            # the page holding position p-1 is written by the sibling's
            # first decode step but still carries prompt K/V before it
            copies.append((lead_pages[shared_n], self._slots[sid].pages[shared_n]))
        st.queue.pop(0)
        return claim, copies

    def _dispatch_copies(self, copies: list[tuple[int, int]]) -> None:
        """One compiled dispatch duplicating all boundary pages admitted
        this round (padded to a power of two; trash-id pad rows)."""
        m = 1
        while m < len(copies):
            m *= 2
        trash = self.n_pages
        src = np.full((m,), trash, np.int32)
        dst = np.full((m,), trash, np.int32)
        for r, (s_pg, d_pg) in enumerate(copies):
            src[r], dst[r] = s_pg, d_pg
        self.pools = self._copy_pages_fn(m)(self.pools, jnp.asarray(src), jnp.asarray(dst))

    def _prefill_admitted(self, admitted: list[tuple[int, int]]) -> None:
        """Dispatch batched prefills: one program per (group bucket, group
        size), padding rows and beyond-own-bucket pages to the trash id.

        Rows whose prompt prefix was served by the prefix cache run the
        cheaper SUFFIX pass instead (or, on a full hit, no compute at all —
        just the n-gram history fill in speculative mode). Dispatch order
        matters within an admission round: full prefills go first and suffix
        rows keep admission order, because a row may gather prefix pages that
        an earlier row of the same round writes (device execution follows
        dispatch order via the donated-pools dependency chain)."""
        st = self._st
        full = [t for t in admitted if self._slots[t[0]].cached_len == 0]
        suffix: list[tuple[int, int]] = []
        hist_only: list[int] = []
        for slot_id, bucket in admitted:
            s = self._slots[slot_id]
            if s.cached_len == 0:
                continue
            if s.cached_len >= len(s.req.prompt) - 1:
                hist_only.append(slot_id)  # decode's first step does the rest
            else:
                suffix.append((slot_id, bucket))
        todo = sorted(full, key=lambda t: t[1])  # by bucket
        trash = self.n_pages  # logical sentinel -> trash row in prefill_prompts
        while todo:
            g = next(s for s in self.PREFILL_GROUPS if s <= len(todo))
            batch, todo = todo[:g], todo[g:]
            bucket = max(b for _, b in batch)
            n_pages_row = bucket // self.page_size
            tokens = np.full((g, bucket), self.pad_id, np.int32)
            page_ids = np.full((g, n_pages_row), trash, np.int32)
            slot_ids = np.full((g,), self.n_slots, np.int32)  # pad rows -> trash hist row
            for r, (slot_id, own_bucket) in enumerate(batch):
                s = self._slots[slot_id]
                tokens[r, : len(s.req.prompt)] = s.req.prompt
                own_n = own_bucket // self.page_size
                page_ids[r, :own_n] = self._page_table[slot_id, :own_n]
                slot_ids[r] = slot_id
            t0 = time.perf_counter()
            if self.speculate_k > 0:
                self.pools, st.hist = self._prefill_fn(bucket, g)(
                    self.params, self.pools, jnp.asarray(tokens), jnp.asarray(page_ids),
                    st.hist, jnp.asarray(slot_ids),
                )
            else:
                self.pools = self._prefill_fn(bucket, g)(
                    self.params, self.pools, jnp.asarray(tokens), jnp.asarray(page_ids)
                )
            st.stats["prefill_block_s"] += time.perf_counter() - t0
            st.stats["prefill_dispatches"] += 1
            st.stats["prefill_rows"] += len(batch)
            st.stats["prefill_token_area"] += g * bucket
            st.stats["weight_bytes"] += self._weight_bytes

        # suffix passes: merge contiguous same-suffix-bucket runs only, so the
        # dispatch sequence preserves admission order (writer-before-reader)
        rows = [
            (sid, self._slots[sid].cached_len, len(self._slots[sid].req.prompt))
            for sid, _b in suffix
        ]
        idx = 0
        while idx < len(rows):
            sb = self._suffix_span(rows[idx])
            j = idx + 1
            while (
                j < len(rows)
                and j - idx < self.PREFILL_GROUPS[0]
                and self._suffix_span(rows[j]) == sb
            ):
                j += 1
            g = next(s for s in self.PREFILL_GROUPS if s <= j - idx)
            self._dispatch_suffix(rows[idx : idx + g], sb, with_hist=True)
            idx += g
        if hist_only and self.speculate_k > 0:
            self._fill_hist(list(hist_only))

    def _fill_hist(self, slot_ids: list[int]) -> None:
        """Seed the n-gram drafter's history rows with the slots' prompts
        (speculative mode), grouped under the same compile-key buckets as
        prefill."""
        st = self._st
        todo = slot_ids
        while todo:
            g = next(s for s in self.PREFILL_GROUPS if s <= len(todo))
            batch, todo = todo[:g], todo[g:]
            f_bucket = max(
                _round_up(len(self._slots[sid].req.prompt), self.prompt_bucket)
                for sid in batch
            )
            tokens = np.full((g, f_bucket), self.pad_id, np.int32)
            ids = np.full((g,), self.n_slots, np.int32)
            for r, sid in enumerate(batch):
                prm = self._slots[sid].req.prompt
                tokens[r, : len(prm)] = prm
                ids[r] = sid
            st.hist = self._hist_fill_fn(f_bucket, g)(
                st.hist, jnp.asarray(tokens), jnp.asarray(ids)
            )

    def _suffix_span(self, row: tuple[int, int, int]) -> int:
        """Padded token span of a suffix/piece row ``(slot_id, start, end)``
        (the compile-key bucket)."""
        _sid, start, end = row
        return _round_up(end - start, self.prompt_bucket)

    def _suffix_fn(self, s_bucket: int, group: int, f_bucket: int | None):
        key = ("suffix", s_bucket, group, f_bucket)
        if key not in self._prefill_cache:
            cfg = self.cfg
            n_pages = self.n_pages
            if self.speculate_k > 0 and f_bucket is not None:
                def pre(params, pools, tokens, start, table, new_ids, hist, full_tokens, slot_ids):
                    return prefill_suffix(
                        params, tokens, start, cfg, pools, table, new_ids, n_pages=n_pages,
                        hist=hist, full_tokens=full_tokens, slot_ids=slot_ids,
                    )

                self._prefill_cache[key] = jax.jit(pre, donate_argnums=(1, 6))
            else:
                def pre(params, pools, tokens, start, table, new_ids):
                    return prefill_suffix(
                        params, tokens, start, cfg, pools, table, new_ids, n_pages=n_pages
                    )

                self._prefill_cache[key] = jax.jit(pre, donate_argnums=(1,))
        return self._prefill_cache[key]

    def _hist_fill_fn(self, f_bucket: int, group: int):
        key = ("hist", f_bucket, group)
        if key not in self._prefill_cache:
            def fill(hist, tokens, slot_ids):
                return hist.at[slot_ids, : tokens.shape[1]].set(tokens)

            self._prefill_cache[key] = jax.jit(fill, donate_argnums=(0,))
        return self._prefill_cache[key]

    def _dispatch_suffix(
        self, batch: list[tuple[int, int, int]], s_bucket: int, *, with_hist: bool
    ) -> None:
        """One suffix-prefill dispatch for ``batch`` rows ``(slot_id, start,
        end)`` sharing a suffix bucket: tokens/start/page-table/new-page
        operands built from host mirrors; trash-pads pages beyond each row's
        owned set. ``with_hist`` records the FULL prompt into the speculative
        n-gram history (final passes only — chunked pieces defer the history
        fill to decode admission)."""
        st = self._st
        trash = self.n_pages
        g = len(batch)
        n_new = s_bucket // self.page_size
        tokens = np.full((g, s_bucket), self.pad_id, np.int32)
        start = np.zeros((g,), np.int32)
        table = np.full((g, self.max_pages_per_seq), trash, np.int32)
        new_ids = np.full((g, n_new), trash, np.int32)
        for r, (slot_id, c, end) in enumerate(batch):
            s = self._slots[slot_id]
            suf = s.req.prompt[c:end]
            tokens[r, : len(suf)] = suf
            start[r] = c
            n_owned = len(s.pages)
            table[r, :n_owned] = self._page_table[slot_id, :n_owned]
            cn = c // self.page_size
            upto = min(n_new, n_owned - cn)
            new_ids[r, :upto] = self._page_table[slot_id, cn : cn + upto]
        t0 = time.perf_counter()
        if self.speculate_k > 0 and with_hist:
            f_bucket = max(
                _round_up(len(self._slots[sid].req.prompt), self.prompt_bucket)
                for sid, _c, _e in batch
            )
            full_tokens = np.full((g, f_bucket), self.pad_id, np.int32)
            slot_ids = np.full((g,), self.n_slots, np.int32)
            for r, (sid, _c, _e) in enumerate(batch):
                prm = self._slots[sid].req.prompt
                full_tokens[r, : len(prm)] = prm
                slot_ids[r] = sid
            self.pools, st.hist = self._suffix_fn(s_bucket, g, f_bucket)(
                self.params, self.pools, jnp.asarray(tokens), jnp.asarray(start),
                jnp.asarray(table), jnp.asarray(new_ids), st.hist,
                jnp.asarray(full_tokens), jnp.asarray(slot_ids),
            )
        else:
            self.pools = self._suffix_fn(s_bucket, g, None)(
                self.params, self.pools, jnp.asarray(tokens), jnp.asarray(start),
                jnp.asarray(table), jnp.asarray(new_ids),
            )
        st.stats["prefill_block_s"] += time.perf_counter() - t0
        st.stats["prefill_dispatches"] += 1
        st.stats["prefill_rows"] += g
        st.stats["prefill_token_area"] += g * s_bucket
        st.stats["weight_bytes"] += self._weight_bytes

    def _advance_prefills(self) -> None:
        """Dispatch ONE piece per chunk-prefilling slot (batched when pieces
        share a bucket), register the pages each piece fills into the prefix
        cache, and open decode for slots whose prompt K/V is now complete."""
        st = self._st
        pieces: list[tuple[int, int, int]] = []
        for sid, s in enumerate(self._slots):
            if s.req is None or not s.prefilling:
                continue
            p = len(s.req.prompt)
            end = min(s.prefilled + self.prefill_chunk, p)
            pieces.append((sid, s.prefilled, end))
        by_bucket: dict[int, list[tuple[int, int, int]]] = {}
        for row in pieces:
            by_bucket.setdefault(self._suffix_span(row), []).append(row)
        for sb, rows in sorted(by_bucket.items()):
            while rows:
                g = next(x for x in self.PREFILL_GROUPS if x <= len(rows))
                batch, rows = rows[:g], rows[g:]
                self._dispatch_suffix(batch, sb, with_hist=False)
                st.stats["prefill_pieces"] += g
        completed: list[int] = []
        for sid, c, end in pieces:
            s = self._slots[sid]
            # register pages fully covered by this piece (content now written)
            upto = min(end // self.page_size, len(s.hashes))
            for i in range(max(c // self.page_size, s.cached_len // self.page_size), upto):
                h = s.hashes[i]
                if h not in self._prefix_map:
                    pg = s.pages[i]
                    self._prefix_map[h] = pg
                    self._page_hash[pg] = h
            s.prefilled = end
            if end >= len(s.req.prompt) - 1:
                s.prefilling = False
                completed.append(sid)
        for sid in completed:
            s = self._slots[sid]
            req = s.req
            p = len(req.prompt)
            if st.use_pen:
                cnt = np.zeros((self.cfg.vocab_size,), np.float32)
                np.add.at(cnt, req.prompt, 1.0)
                st.prompt_counts[sid] = cnt
            st.active[sid] = True
            st.admit[sid] = 1
            st.admit_seq[sid] = p - 1
            st.admit_tok[sid] = req.prompt[-1]
            st.admit_budget[sid] = req.max_tokens if req.max_tokens is not None else st.sp.max_tokens
            st.prompt_lens[sid] = p
        if completed and self.speculate_k > 0:
            self._fill_hist(completed)

    def _collect(
        self, slot_id: int, *, keep_tokens: int | None = None, finish_reason: str | None = None
    ) -> None:
        st = self._st
        sp = st.sp
        slot = self._slots[slot_id]
        req = slot.req
        token_ids = req.out[: req.max_tokens if req.max_tokens is not None else sp.max_tokens]
        if keep_tokens is not None:  # cancel_request's stop-string cut
            token_ids = token_ids[:keep_tokens]
        stopped = bool(token_ids) and token_ids[-1] in st.stop_set and finish_reason is None
        st.results[req.idx, req.seq] = {
            "token_ids": token_ids,
            "finish_reason": finish_reason if finish_reason is not None
            else ("stop" if stopped else "length"),
            "stop_reason": token_ids[-1] if stopped else None,
            "cumulative_logprob": req.clp if keep_tokens is None
            else float(sum(req.lps[: len(token_ids)])) if req.lps else req.clp,
            # per-token logprobs of the emitted tokens (vLLM's logprobs role;
            # plain floats, not the token->Logprob dicts). None in spec mode.
            "logprobs": req.lps[: len(token_ids)] if req.lps else None,
        }
        self._free_slot(slot)
        st.active[slot_id] = False
        st.collected[req.idx] = st.collected.get(req.idx, 0) + 1
        if st.collected[req.idx] == st.expected[req.idx]:
            st.completed.append(req.idx)

    def _harvest(self, p: dict) -> None:
        st = self._st
        t0 = time.perf_counter()
        packed = np.asarray(jax.device_get(p["packed"]))
        st.stats["harvest_block_s"] += time.perf_counter() - t0
        if self.speculate_k > 0:  # [tokens | done | seq_len | clp | verify-steps]
            chunk = packed.shape[1] - 4
            lps_h = None
            tail = packed[:, chunk:]
            st.stats["verify_steps"] += int(tail[:, 3].sum())
        else:  # [tokens | per-token logprobs (bitcast) | done | seq_len | clp]
            chunk = (packed.shape[1] - 3) // 2
            lps_h = packed[:, chunk : 2 * chunk].view(np.float32)
            tail = packed[:, 2 * chunk :]
        emitted_h = packed[:, :chunk]
        done_h = tail[:, 0] != 0
        lens_h = tail[:, 1]
        clp_h = tail[:, 2].view(np.float32)
        for slot_id, req_snapshot in p["in_chunk"]:
            s = self._slots[slot_id]
            if s.req is not req_snapshot or s.done:
                continue
            n_new = int(lens_h[slot_id]) - s.seq_len
            s.seq_len = int(lens_h[slot_id])
            if n_new > 0:
                s.req.out.extend(int(t) for t in emitted_h[slot_id, :n_new])
                if lps_h is not None:
                    s.req.lps.extend(float(x) for x in lps_h[slot_id, :n_new])
                s.req.clp += float(clp_h[slot_id])
                s.n_out += n_new
                st.stats["tokens_out"] += n_new
            if bool(done_h[slot_id]):
                s.done = True
                self._collect(slot_id)

    def _harvest_oldest(self) -> None:
        self._harvest(self._st.pending.popleft())

    def step(self) -> list[dict[str, Any]]:
        """Run ONE scheduler iteration on the active stream: opportunistically
        harvest ready chunks, admit queued requests into free slots (batched
        prefill + boundary-page forks), provision pages (preempting if the pool
        runs dry), dispatch one decode chunk, and block-harvest the oldest
        in-flight chunk once the pipeline is full.

        Returns the requests that COMPLETED during this iteration, each as
        ``{"request_id": int, "outputs": [sp.n result dicts]}``. An iteration
        that only waits (e.g. gang larger than current free slots) returns [].

        Up to ``pipeline_depth`` chunks are kept IN FLIGHT while older chunks'
        results are harvested: each harvest's device_get costs a full
        host<->device round trip, and queued chunks keep the device busy
        through it. Bookkeeping consequences: page capacity is provisioned
        (depth+1) chunks ahead for in-flight slots, harvests identity-check
        the request (a slot freed and re-admitted between dispatch and
        harvest is skipped — its old request was fully collected when it
        went done), and a request that finishes mid-flight idles its slot
        for up to ``depth`` extra chunks (done latches on device, so it stops
        advancing; it is collected when its chunk is harvested)."""
        st = self._require_stream()
        try:
            self._step_inner(st)
        except BaseException:
            # a slot admitted this iteration may have registered prefix-cache
            # pages whose prefill never dispatched — invalidate the cache
            # wholesale before releasing pages
            self._clear_prefix_cache()
            self.end_stream()  # release every claimed slot/page; drop in-flight chunks
            raise
        out = []
        while st.completed:
            idx = st.completed.popleft()
            out.append({
                "request_id": idx,
                "outputs": [st.results.pop((idx, j)) for j in range(st.expected.pop(idx))],
            })
            st.collected.pop(idx, None)
        return out

    def _step_inner(self, st: "_Stream") -> None:
        sp = st.sp
        # 0) opportunistic harvest: collect any in-flight chunk whose
        # result is already computed (copy_to_host_async was issued at
        # dispatch, so device_get is a cheap host-buffer read). This
        # refills done slots ~pipeline_depth chunks earlier than the
        # blocking harvest alone — with mean generations of only a few
        # chunks, that idle time is the dominant occupancy loss.
        while st.pending and st.pending[0]["packed"].is_ready():
            self._harvest_oldest()

        # 1) admit new prompt groups into free slots (a group's n
        # sequences go in together so they can share prefix pages),
        # then prefill the leaders batched + fork boundary pages
        admitted: list[tuple[int, int]] = []
        copies: list[tuple[int, int]] = []
        free_ids = [i for i, s in enumerate(self._slots) if s.req is None]
        while st.queue and not st.suspend_admission and 0 < len(st.queue[0]) <= len(free_ids):
            res = self._admit_group(st.queue[0], free_ids[: len(st.queue[0])])
            if res is None:
                break  # pool tight: stop admitting, let running slots finish
            claim, group_copies = res
            if not self._slots[claim[0]].prefilling:
                admitted.append(claim)  # chunk-prefilling slots piece through _advance_prefills
            copies.extend(group_copies)
            free_ids = free_ids[len(group_copies) + 1 :]
        if admitted:
            self._prefill_admitted(admitted)
        if copies:
            self._dispatch_copies(copies)
        if self.prefill_chunk is not None:
            self._advance_prefills()

        runnable = [
            i for i, s in enumerate(self._slots)
            if s.req is not None and not s.done and not s.prefilling
        ]
        if not runnable:
            if any(s.req is not None and s.prefilling for s in self._slots):
                # decode is idle but chunked prefills are progressing; keep
                # harvesting so done slots free up while pieces dispatch
                if st.pending:
                    self._harvest_oldest()
                return
            if st.pending:
                self._harvest_oldest()
                return
            if st.suspend_admission:
                st.suspend_admission = False  # nothing else can progress; retry admission
                return
            if st.queue and not admitted:
                if len(st.queue[0]) > 1:
                    # the gang does not fit together in an otherwise idle
                    # engine: split it — each sequence runs solo (its fit
                    # was validated upfront), trading page sharing for
                    # progress
                    for r in st.queue[0]:
                        r.requeued = True  # hold the front across sorted admission orders
                    st.queue[:1] = [[r] for r in st.queue[0]]
                    return
                # nothing is running, every page is free, and a prompt still
                # does not fit: the pool is fundamentally undersized
                raise RuntimeError("KV page pool too small to admit any prompt; raise n_pages")
            return  # everything admitted finished instantly -> re-admit / exit

        # 2) make sure every running slot has pages for the next chunk
        # (in-flight slots may already be several chunks ahead of the
        # host mirror, so provision depth+1)
        chunks_ahead: dict[int, int] = {}
        for p in st.pending:
            for sid, req_snapshot in p["in_chunk"]:
                # a freed-and-re-admitted slot's pending entries belong to
                # the OLD request — they stopped advancing (done latched),
                # so they must not inflate the new request's lookahead
                if self._slots[sid].req is req_snapshot:
                    chunks_ahead[sid] = chunks_ahead.get(sid, 0) + 1
        for slot_id in runnable:
            s = self._slots[slot_id]
            if s.req is None or s.done:
                continue  # may have been preempted while provisioning others
            # speculative steps advance up to k+1 tokens and WRITE one draft
            # window past the final advance — provision for both
            t_mult = self.speculate_k + 1
            lookahead = self.chunk * t_mult * (1 + chunks_ahead.get(slot_id, 0)) + (t_mult - 1)
            mt = s.req.max_tokens if s.req.max_tokens is not None else sp.max_tokens
            cap = max(
                _round_up(len(s.req.prompt), self.prompt_bucket),
                len(s.req.prompt) + mt,
            )
            target = min(s.seq_len + lookahead + 1, self.max_context, cap)
            while not self._ensure_capacity(slot_id, target):
                if st.pending:
                    # free what in-flight chunks have finished before
                    # resorting to preemption
                    while st.pending:
                        self._harvest_oldest()
                    chunks_ahead = {}
                    if self._slots[slot_id].req is None or self._slots[slot_id].done:
                        break
                    continue
                victim = self._preempt_youngest(st.queue)
                if victim is None:
                    raise RuntimeError("KV page pool exhausted and nothing to preempt")
                st.stats["preemptions"] += 1
                st.active[victim] = False  # stop the decode mask advancing a freed slot
                st.admit[victim] = 0  # drop any not-yet-dispatched admission override
                if self._slots[slot_id].req is None:  # we preempted ourselves
                    # let the surviving slots make progress before this
                    # request is re-admitted, or the cycle never dispatches
                    st.suspend_admission = True
                    return

        # 3) dispatch one compiled chunk for every active slot (async).
        # Chunk-prefilling slots are NOT in-chunk: they are inactive in the
        # control array AND their device-side done flag still holds the
        # previous occupant's latched value — harvesting them would collect
        # an unstarted request.
        runnable = [
            i for i, s in enumerate(self._slots)
            if s.req is not None and not s.done and not s.prefilling
        ]
        if not runnable:
            return
        t0 = time.perf_counter()
        control = np.concatenate(
            [
                np.stack(
                    [st.active.astype(np.int32), st.admit, st.admit_seq,
                     st.admit_tok, st.admit_budget, st.prompt_lens,
                     # per-slot sampling params (f32 columns bitcast to i32)
                     st.slot_temp.view(np.int32), st.slot_top_p.view(np.int32),
                     st.slot_top_k, st.slot_pres.view(np.int32),
                     st.slot_freq.view(np.int32), st.slot_rep.view(np.int32),
                     st.slot_seed],
                    axis=1,
                ),
                self._page_table,
            ],
            axis=1,
        )
        if self.speculate_k > 0:
            (self.pools, st.seq_lens, st.tok, st.done, st.budget, st.hist, st.key, packed) = st.chunk_fn(
                self.params, self.pools, jnp.asarray(control), st.seq_lens, st.tok, st.done, st.budget,
                st.hist, st.key,
            )
        else:
            pc_dev = jnp.asarray(st.prompt_counts) if st.use_pen else jnp.zeros((1, 1), jnp.float32)
            (self.pools, st.seq_lens, st.tok, st.done, st.budget, st.out_counts, st.key, packed) = st.chunk_fn(
                self.params, self.pools, jnp.asarray(control), st.seq_lens, st.tok, st.done, st.budget,
                st.out_counts, pc_dev, st.key,
            )
        st.admit[:] = 0  # consumed by this dispatch
        st.stats["dispatch_block_s"] += time.perf_counter() - t0
        st.stats["chunk_dispatches"] += 1
        st.stats["slot_chunks"] += len(runnable)
        # roofline accounting (non-spec path; the spec chunk's window reads
        # vary with acceptance): each scan step streams the weights once and
        # DMAs each runnable slot's page-rounded history (inactive slots DMA
        # nothing — decode_step_tokens zeroes their attn_lens)
        if self.speculate_k == 0:
            t_mult = np.arange(self.chunk, dtype=np.int64)
            hl = np.array(
                [self._slots[i].seq_len + self.chunk * chunks_ahead.get(i, 0) for i in runnable],
                np.int64,
            )
            pages = -(-(hl[:, None] + t_mult[None, :]) // self.page_size)  # ceil
            kvd = self.pools["k"].shape[2]
            st.stats["kv_bytes"] += (
                float(pages.sum()) * self.page_size * kvd
                * self.pools["k"].dtype.itemsize * 2 * self.cfg.num_layers
            )
            st.stats["weight_bytes"] += self.chunk * self._weight_bytes
        st.suspend_admission = False  # a chunk dispatched: progress is real
        packed.copy_to_host_async()  # ONE transfer request per chunk
        st.pending.append({
            "packed": packed,
            "in_chunk": [(i, self._slots[i].req) for i in runnable],
        })

        # 4) harvest the oldest chunk once the pipeline is full — the
        # remaining queued chunks keep the device busy through the get
        if len(st.pending) >= self.pipeline_depth:
            self._harvest_oldest()

    # --- batch driver ---------------------------------------------------------------

    def generate_batch(
        self, prompts: list[list[int]], sp: SamplingParams, key: jax.Array | None = None
    ) -> list[dict[str, Any]]:
        """Generate for ragged prompts with continuous batching; returns vLLM-shaped
        dicts in prompt order (same schema as DecodeEngine.generate_batch).

        With ``sp.n > 1`` each prompt yields ``n`` sequences and the returned
        list is prompt-major / sequence-minor (``len == len(prompts) * sp.n``).
        The n sequences of a prompt are admitted together and SHARE the
        prompt's fully-read-only KV pages by reference (one prefill, one
        boundary-page copy per extra sequence) — the memory/compute sharing
        vLLM's parallel sampling is built on.

        Thin driver over the streaming API: begin_stream -> add_request xN ->
        step until idle -> end_stream."""
        self.begin_stream(sp, key)
        try:
            ids = [self.add_request(t) for t in prompts]
            by_id: dict[int, list[dict[str, Any]]] = {}
            while not self.stream_idle:
                for rec in self.step():
                    by_id[rec["request_id"]] = rec["outputs"]
        finally:
            # step() already released everything on an exception (end_stream is
            # idempotent); on success this just finalizes stats
            self.end_stream()
        return [res for i in ids for res in by_id[i]]
