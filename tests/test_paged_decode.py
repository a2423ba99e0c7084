"""Paged-KV continuous-batching engine: correctness vs the dense engine and the
naive full-recompute reference, plus scheduler behavior (refill, preemption).

The paged engine is the vLLM-role replacement named by the north star
(ref: scripts/generate.py:112-118); greedy outputs must match DecodeEngine.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.generate.engine import DecodeEngine, SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine
from ssi_jax.models.llama3 import forward, init_params, logits
from tests import helpers


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, params


def make_engine(params, cfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prompt_bucket", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    kw.setdefault("attn_impl", "gather")
    return PagedDecodeEngine(params, cfg, pad_id=0, **kw)


naive_greedy = helpers.naive_greedy  # fixed-shape oracle (see helpers docstring)


def test_greedy_matches_naive_and_dense(setup):
    cfg, params = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())

    paged = make_engine(params, cfg)
    outs = paged.generate_batch(prompts, sp)

    dense = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    dense_outs = dense.generate_batch(prompts[:4], sp)  # dense engine: fixed batch

    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        expected = naive_greedy(params, cfg, prompt, 6)
        assert out["token_ids"] == expected, f"prompt {i}: {out['token_ids']} != {expected}"
        assert out["finish_reason"] == "length"
    for dense_out, paged_out in zip(dense_outs, outs):
        assert dense_out["token_ids"] == paged_out["token_ids"]
        assert dense_out["cumulative_logprob"] == pytest.approx(paged_out["cumulative_logprob"], abs=1e-3)


def test_continuous_batching_refills_slots(setup):
    """More prompts than slots: finished slots admit queued prompts, all outputs
    are returned in request order, and every page is freed at the end."""
    cfg, params = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))).tolist() for _ in range(11)]
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())

    engine = make_engine(params, cfg, n_slots=3)
    outs = engine.generate_batch(prompts, sp)
    assert len(outs) == len(prompts)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 5)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages  # no page leaks
    assert all(s.req is None for s in engine._slots)


def test_stop_tokens_and_budget(setup):
    cfg, params = setup
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    first = naive_greedy(params, cfg, prompt, 1)[0]

    engine = make_engine(params, cfg)
    out = engine.generate_batch([prompt], SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=(first,)))[0]
    assert out["token_ids"] == [first]
    assert out["finish_reason"] == "stop"
    assert out["stop_reason"] == first

    # a later token as stop: exercises the in-chunk stop path (find a step whose
    # token differs from all earlier ones so the stop fires exactly there)
    seq = naive_greedy(params, cfg, prompt, 8)
    stop_at = next((i for i in range(1, 8) if seq[i] not in seq[:i]), None)
    if stop_at is not None:
        sp2 = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=(seq[stop_at],))
        out = engine.generate_batch([prompt], sp2)[0]
        assert out["token_ids"] == seq[: stop_at + 1]
        assert out["finish_reason"] == "stop"

    # max_tokens budget exact
    out = engine.generate_batch([prompt], SamplingParams(temperature=0.0, max_tokens=3, stop_token_ids=()))[0]
    assert len(out["token_ids"]) == 3
    assert out["finish_reason"] == "length"


def test_preemption_on_tiny_pool(setup):
    """A pool sized so concurrent slots exhaust pages mid-run must preempt and
    still produce correct outputs for every request."""
    cfg, params = setup
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, stop_token_ids=())
    # each sequence needs ceil((8 prompt + 12 out + chunk slack)/8) pages ~ 4;
    # give the pool 7 pages so two concurrent sequences cannot both finish
    engine = make_engine(params, cfg, n_slots=2, n_pages=7)
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 12)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_pool_too_small_raises(setup):
    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=1, n_pages=1)
    prompt = list(range(10))  # bucket 16 -> needs 2 pages immediately
    with pytest.raises(RuntimeError, match="pool too small"):
        engine.generate_batch([prompt], SamplingParams(temperature=0.0, max_tokens=4))


def test_context_overflow_rejected(setup):
    cfg, params = setup
    engine = make_engine(params, cfg, max_context=32)
    with pytest.raises(ValueError, match="exceeds"):
        engine.generate_batch([list(range(20))], SamplingParams(temperature=0.0, max_tokens=20))


def test_sampling_with_penalties_runs(setup):
    """Penalty path (out/prompt counts) compiles and emits max_tokens tokens."""
    cfg, params = setup
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 7).tolist() for _ in range(3)]
    sp = SamplingParams(
        temperature=0.8, top_k=20, max_tokens=6,
        presence_penalty=0.5, frequency_penalty=0.2, repetition_penalty=1.1,
    )
    engine = make_engine(params, cfg)
    outs = engine.generate_batch(prompts, sp, key=jax.random.key(11))
    for out in outs:
        assert len(out["token_ids"]) == 6
        assert np.isfinite(out["cumulative_logprob"])


def test_failed_admission_releases_pages(setup):
    """A prompt that cannot be admitted must not strand its partial page
    allocation on a req=None slot (the pool would shrink permanently)."""
    from ssi_jax.generate.engine import SamplingParams

    cfg, params = setup
    # pool of 6 pages, page_size 8: a 4-page prompt + a 2-page prompt can
    # never be resident together with a third request
    eng = make_engine(params, cfg, n_slots=2, n_pages=6, max_context=48)
    free_before = len(eng._free_pages) + len(eng._cache_lru)
    sp = SamplingParams(temperature=0.0, max_tokens=2, stop_token_ids=())
    prompts = [[1] * 30, [2] * 10, [3] * 14]  # 4 + 2 + 2 pages of prompt
    outs = eng.generate_batch(prompts, sp)
    assert len(outs) == 3 and all(len(o["token_ids"]) == 2 for o in outs)
    # every page returned to the free list after the batch drains
    assert len(eng._free_pages) + len(eng._cache_lru) == free_before


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_fuzz_matches_dense(setup, seed):
    """Property test over the scheduler: random ragged workloads, small/tight
    pools (forcing refill and preemption), random stop sets — greedy outputs
    must match the dense engine bitwise, every page must return to the free
    list, and the run must terminate (the livelock class this guards against
    was found by exactly such a workload)."""
    from ssi_jax.generate.engine import DecodeEngine, SamplingParams

    cfg, params = setup
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 5))
    max_tokens = int(rng.integers(2, 9))
    n_prompts = int(rng.integers(3, 10))
    prompts = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(4, 40, n_prompts)]
    # pool between "snug" and "roomy": sometimes forces preemption/queueing
    need = max(-(-(max(len(p) for p in prompts) + max_tokens) // 8), 2)
    n_pages = int(rng.integers(need, need * n_slots + 2))
    stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, 8, replace=False)) if rng.random() < 0.5 else ()
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=stops)

    eng = make_engine(
        params, cfg, n_slots=n_slots, n_pages=n_pages,
        max_context=max(len(p) for p in prompts) + max_tokens + 8,
        chunk=int(rng.integers(2, 6)),
    )
    free_before = len(eng._free_pages) + len(eng._cache_lru)
    got = eng.generate_batch(prompts, sp)
    assert len(eng._free_pages) + len(eng._cache_lru) == free_before  # no page leaked

    dense = DecodeEngine(params, cfg, pad_id=0)
    want = dense.generate_batch(prompts, sp)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["token_ids"] == w["token_ids"], (seed, i)
        assert g["finish_reason"] == w["finish_reason"], (seed, i)


def test_int8_weight_only_decode(setup):
    """Weight-only int8: engine runs end-to-end, dequantized logits stay close
    to bf16 (per-channel symmetric error bound), outputs share the schema."""
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.quant import matmul, quantize_layer_weights_int8

    cfg, params = setup
    qparams = quantize_layer_weights_int8(params)
    # per-leaf dequant error: |w - q*scale| <= scale/2 per element
    for name in ("wq", "w_down"):
        w = np.asarray(params["layers"][name], np.float32)
        leaf = qparams["layers"][name]
        deq = np.asarray(leaf["q"], np.float32) * np.asarray(leaf["scale"], np.float32)
        amax = np.abs(w).max(axis=-2, keepdims=True)
        assert np.all(np.abs(w - deq) <= amax / 127.0 + 1e-6), name
    # matmul dispatch: quantized result close to exact
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, params["layers"]["wq"].shape[1])), jnp.float32)
    exact = x @ params["layers"]["wq"][0]
    approx = matmul(x, jax.tree.map(lambda a: a[0], qparams["layers"]["wq"]))
    np.testing.assert_allclose(np.asarray(approx), np.asarray(exact), atol=0.15, rtol=0.15)

    eng = make_engine(params, cfg, quantize="int8")
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    outs = eng.generate_batch([[1, 2, 3, 4, 5], [7, 8, 9]], sp)
    assert all(len(o["token_ids"]) == 6 for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o["token_ids"])

    with pytest.raises(ValueError, match="quantize"):
        make_engine(params, cfg, quantize="fp8")


def test_bad_page_size_rejected(setup):
    """page_size must be a positive multiple of 8 (prompt-bucket alignment)."""
    cfg, params = setup
    with pytest.raises(ValueError, match="multiple of 8"):
        make_engine(params, cfg, page_size=4, prompt_bucket=8)


def test_exception_mid_run_releases_pool(setup):
    """A failure after slots/pages are claimed must release them: the engine
    must stay fully usable (same free list, same outputs) for the next call."""
    cfg, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [6, 12, 4]]
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())
    engine = make_engine(params, cfg)
    expected = engine.generate_batch(prompts, sp)

    orig = engine._chunk_fn

    def failing_chunk_fn(sp_arg, feats=frozenset()):
        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")
        return boom

    engine._chunk_fn = failing_chunk_fn
    with pytest.raises(RuntimeError, match="injected"):
        engine.generate_batch(prompts, sp)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    assert all(s.req is None for s in engine._slots)

    engine._chunk_fn = orig
    again = engine.generate_batch(prompts, sp)
    assert [o["token_ids"] for o in again] == [o["token_ids"] for o in expected]


def test_last_stats_contract(setup):
    """generate_batch refreshes last_stats with a consistent accounting of the
    run: every generated token harvested, occupancy in (0, 1], dispatch counts."""
    cfg, params = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = engine.generate_batch(prompts, sp)
    s = engine.last_stats
    assert s["tokens_out"] == sum(len(o["token_ids"]) for o in outs)
    assert s["prompt_tokens"] == sum(len(p) for p in prompts)
    assert s["prefill_rows"] == len(prompts)
    assert s["chunk_dispatches"] > 0 and 0.0 < s["slot_occupancy"] <= 1.0
    assert s["preemptions"] == 0
    assert s["wall_s"] >= s["harvest_block_s"] >= 0.0


def test_per_token_logprobs(setup):
    """Each output carries per-token logprobs (vLLM's logprobs role, ref:
    scripts/generate.py output fields): one float per emitted token, summing
    to the cumulative logprob; spec mode returns None (not computed there)."""
    cfg, params = setup
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = engine.generate_batch(prompts, sp)
    for out in outs:
        assert out["logprobs"] is not None
        assert len(out["logprobs"]) == len(out["token_ids"])
        assert sum(out["logprobs"]) == pytest.approx(out["cumulative_logprob"], abs=1e-4)
        assert all(lp <= 0.0 for lp in out["logprobs"])
    spec = make_engine(params, cfg, speculate_k=2)
    for out in spec.generate_batch(prompts, sp):
        assert out["logprobs"] is None


def test_cancel_request_mid_run(setup):
    """Host-side cancel (vLLM abort_request role): a running request finalizes
    immediately with the given reason + truncation, survivors are unaffected,
    and every page returns to the pool."""
    cfg, params = setup
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 9, 7]]
    sp = SamplingParams(temperature=0.0, max_tokens=12, stop_token_ids=())
    engine = make_engine(params, cfg)
    engine.begin_stream(sp)
    rids = [engine.add_request(p) for p in prompts]
    outs: dict[int, list] = {}
    cancelled = False
    for _ in range(200):
        for rec in engine.step():
            outs[rec["request_id"]] = rec["outputs"]
        if not cancelled and rids[1] not in outs:
            live = [s for s in engine._slots if s.req is not None and s.req.idx == rids[1]]
            if live and len(live[0].req.out) >= 3 and not live[0].done:
                assert engine.cancel_request(rids[1], keep_tokens=3, finish_reason="stop")
                cancelled = True
        if len(outs) == 3:
            break
    assert cancelled and len(outs) == 3
    out1 = outs[rids[1]][0]
    assert out1["finish_reason"] == "stop"
    assert out1["token_ids"] == naive_greedy(params, cfg, prompts[1], 3)
    assert len(out1["logprobs"]) == 3
    for i in (0, 2):
        assert outs[rids[i]][0]["token_ids"] == naive_greedy(params, cfg, prompts[i], 12)
    engine.end_stream()
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    # unknown / already-completed ids are a no-op False
    engine.begin_stream(sp)
    assert not engine.cancel_request(999)
    engine.end_stream()


def test_cancel_request_queued(setup):
    """Cancelling a request still waiting in the admission queue finalizes it
    with an empty output and does not disturb the running ones."""
    cfg, params = setup
    rng = np.random.default_rng(35)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(6)]
    sp = SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=())
    engine = make_engine(params, cfg)  # 4 slots < 6 prompts
    engine.begin_stream(sp)
    rids = [engine.add_request(p) for p in prompts]
    engine.step()  # admits the first 4; the last 2 stay queued
    assert engine.cancel_request(rids[5], finish_reason="abort")
    outs: dict[int, list] = {}
    for _ in range(300):
        for rec in engine.step():
            outs[rec["request_id"]] = rec["outputs"]
        if len(outs) == 6:
            break
    assert len(outs) == 6
    assert outs[rids[5]][0] == {
        "token_ids": [], "finish_reason": "abort", "stop_reason": None,
        "cumulative_logprob": 0.0, "logprobs": None,
    }
    for i in range(5):
        assert outs[rids[i]][0]["token_ids"] == naive_greedy(params, cfg, prompts[i], 10), i
    engine.end_stream()
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_n_parallel_sampling_greedy_shares_pages(setup):
    """n>1: each prompt yields n sequences (prompt-major order); with greedy
    sampling all siblings equal the n=1 output bitwise — proving the shared
    prefix pages + forked boundary page reconstruct the exact same KV state.
    The free list must be fully restored (refcount accounting)."""
    cfg, params = setup
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 17, 11]]
    engine = make_engine(params, cfg, n_slots=8)
    free0 = len(engine._free_pages) + len(engine._cache_lru)

    solo = engine.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=()))
    sp3 = SamplingParams(n=3, temperature=0.0, max_tokens=6, stop_token_ids=())
    outs = engine.generate_batch(prompts, sp3)

    assert len(outs) == 3 * len(prompts)
    for i in range(len(prompts)):
        for j in range(3):
            assert outs[i * 3 + j]["token_ids"] == solo[i]["token_ids"], (i, j)
    assert engine.last_stats["pages_shared"] > 0  # prompt 17 spans >= 2 pages (ps=8)
    assert len(engine._free_pages) + len(engine._cache_lru) == free0
    assert (engine._page_refs == 0).all()


def test_n_sampling_temperature_independent_streams(setup):
    """n=4 stochastic sampling: siblings draw independent tokens (same logits,
    per-row Gumbel noise) — at least one pair of sequences must differ."""
    cfg, params = setup
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    engine = make_engine(params, cfg, n_slots=4)
    sp = SamplingParams(n=4, temperature=1.0, max_tokens=8, stop_token_ids=())
    outs = engine.generate_batch([prompt], sp, key=jax.random.key(5))
    assert len(outs) == 4
    seqs = [tuple(o["token_ids"]) for o in outs]
    assert len(set(seqs)) > 1
    assert all(len(s) == 8 for s in seqs)
    assert all(np.isfinite(o["cumulative_logprob"]) for o in outs)


def test_n_gang_splits_when_pool_tight(setup):
    """A gang that can never sit together in the pool must split into solo
    sequences and still produce n correct greedy outputs."""
    cfg, params = setup
    prompt = [3] * 20  # 3 pages of prompt (ps=8), bucket 24
    engine = make_engine(params, cfg, n_slots=4, n_pages=7, max_context=48)
    solo = engine.generate_batch([prompt], SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=()))
    sp = SamplingParams(n=3, temperature=0.0, max_tokens=4, stop_token_ids=())
    outs = engine.generate_batch([prompt], sp)
    assert len(outs) == 3
    for o in outs:
        assert o["token_ids"] == solo[0]["token_ids"]
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_streaming_api_dynamic_arrivals(setup):
    """The serving API: requests added BETWEEN step() calls join the running
    batch (continuous batching with dynamic arrivals) and produce the same
    greedy outputs as a one-shot batch call."""
    cfg, params = setup
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())

    engine = make_engine(params, cfg)
    batch = engine.generate_batch(prompts, sp)

    engine.begin_stream(sp)
    ids = [engine.add_request(prompts[0]), engine.add_request(prompts[1])]
    got: dict[int, list] = {}
    steps = 0
    late = 2
    while not engine.stream_idle or late < len(prompts):
        for rec in engine.step():
            got[rec["request_id"]] = rec["outputs"]
        steps += 1
        if late < len(prompts):  # trickle one new request in per step
            ids.append(engine.add_request(prompts[late]))
            late += 1
    engine.end_stream()

    assert len(got) == len(prompts)
    for i, rid in enumerate(ids):
        assert got[rid][0]["token_ids"] == batch[i]["token_ids"], i
    assert engine._st is None
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_streaming_api_guards(setup):
    """Stream lifecycle contracts: step/add before begin raise; double begin
    raises; end_stream mid-flight aborts and releases the pool."""
    cfg, params = setup
    engine = make_engine(params, cfg)
    sp = SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=())
    with pytest.raises(RuntimeError, match="No active stream"):
        engine.step()
    with pytest.raises(RuntimeError, match="No active stream"):
        engine.add_request([1, 2, 3])
    engine.begin_stream(sp)
    with pytest.raises(RuntimeError, match="already active"):
        engine.begin_stream(sp)
    engine.add_request([1, 2, 3, 4, 5])
    engine.step()  # admit + dispatch
    engine.end_stream()  # abort mid-request
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    # engine remains fully usable
    outs = engine.generate_batch([[1, 2, 3]], sp)
    assert len(outs[0]["token_ids"]) == 4


# --- speculative decoding (device-side n-gram drafting) --------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_spec_decode_matches_naive(setup, k):
    """speculate_k > 0 must be LOSSLESS: outputs exactly equal the naive
    sequential greedy stream (acceptance is argmax equality), across slot
    refills, with real acceptance happening (tokens_per_verify > 1 on this
    workload — tiny-model greedy streams cycle, feeding the bigram drafter)."""
    cfg, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    sp = SamplingParams(temperature=0.0, max_tokens=12, stop_token_ids=())

    engine = make_engine(params, cfg, n_slots=4, speculate_k=k)
    outs = engine.generate_batch(prompts, sp)

    for i, (prompt, out) in enumerate(zip(prompts, outs)):
        expected = naive_greedy(params, cfg, prompt, 12)
        assert out["token_ids"] == expected, f"k={k} prompt {i}"
        assert out["finish_reason"] == "length"
    st = engine.last_stats
    assert st["verify_steps"] > 0
    assert st["tokens_out"] == 6 * 12
    assert st["tokens_per_verify"] > 1.0  # speculation actually accepted tokens
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages  # no page leaks
    assert all(s.req is None for s in engine._slots)


def test_spec_decode_stop_and_budget(setup):
    """Stop tokens fire at the exact sequential position even when emitted
    mid-acceptance-window, and max_tokens budgets are exact."""
    cfg, params = setup
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    seq = naive_greedy(params, cfg, prompt, 8)

    engine = make_engine(params, cfg, speculate_k=3)
    # first emitted token as stop
    out = engine.generate_batch(
        [prompt], SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=(seq[0],))
    )[0]
    assert out["token_ids"] == [seq[0]]
    assert out["finish_reason"] == "stop"
    assert out["stop_reason"] == seq[0]

    # a later first-occurrence token as stop: must truncate exactly there
    stop_at = next((i for i in range(1, 8) if seq[i] not in seq[:i]), None)
    if stop_at is not None:
        sp2 = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=(seq[stop_at],))
        out = engine.generate_batch([prompt], sp2)[0]
        assert out["token_ids"] == seq[: stop_at + 1]
        assert out["finish_reason"] == "stop"

    # budget exact, clp matches the non-speculative engine
    sp3 = SamplingParams(temperature=0.0, max_tokens=3, stop_token_ids=())
    out = engine.generate_batch([prompt], sp3)[0]
    assert out["token_ids"] == seq[:3]
    base = make_engine(params, cfg).generate_batch([prompt], sp3)[0]
    assert out["cumulative_logprob"] == pytest.approx(base["cumulative_logprob"], abs=1e-3)


def test_spec_decode_guards(setup):
    """Lossless speculation is greedy/n=1-only; out-of-range k rejected."""
    cfg, params = setup
    with pytest.raises(ValueError, match="speculate_k"):
        make_engine(params, cfg, speculate_k=-1)
    with pytest.raises(ValueError, match="speculate_k"):
        make_engine(params, cfg, speculate_k=8)

    engine = make_engine(params, cfg, speculate_k=2)
    with pytest.raises(ValueError, match="greedy"):
        engine.generate_batch([[1, 2]], SamplingParams(temperature=0.7, max_tokens=2))
    with pytest.raises(ValueError, match="penalt"):
        engine.generate_batch(
            [[1, 2]], SamplingParams(temperature=0.0, max_tokens=2, repetition_penalty=1.2)
        )
    with pytest.raises(ValueError, match="n == 1"):
        engine.generate_batch([[1, 2]], SamplingParams(temperature=0.0, max_tokens=2, n=2))


def test_spec_decode_streaming_refills(setup):
    """Slot reuse under speculation: a freed slot's history row is reseeded by
    the next admission's prefill (stale tail beyond the new length is never
    read); dynamic arrivals match the batch path."""
    cfg, params = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))).tolist() for _ in range(9)]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())

    engine = make_engine(params, cfg, n_slots=3, speculate_k=2)
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 6)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


# --- cross-request prefix caching (vLLM automatic prefix caching role) ------------


def _cache_invariant(engine):
    """Page accounting with an idle engine: every page is free or parked in the
    cache LRU; hash maps are 1:1."""
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    assert set(engine._page_hash) == set(engine._prefix_map.values())
    assert set(engine._page_hash.values()) == set(engine._prefix_map)
    for pg in engine._cache_lru:
        assert engine._page_refs[pg] == 0


def test_prefix_cache_cross_request_lossless(setup):
    """A second stream whose prompts extend a cached prefix must (a) reuse
    pages (cached_prompt_tokens > 0), (b) prefill only the tail, and (c) emit
    exactly the uncached greedy stream."""
    cfg, params = setup
    rng = np.random.default_rng(31)
    base = rng.integers(0, cfg.vocab_size, 21).tolist()  # 2 full ps=8 pages cacheable
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())

    engine = make_engine(params, cfg)
    outs1 = engine.generate_batch([base], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 0
    area1 = engine.last_stats["prefill_token_area"]
    _cache_invariant(engine)

    # same prompt again: full hit — (p-1)//ps * ps = 16 tokens from cache
    outs2 = engine.generate_batch([base], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert outs2[0]["token_ids"] == outs1[0]["token_ids"]

    # an extension: shares the 2 cached pages, suffix pass for the tail only
    ext = base[:16] + rng.integers(0, cfg.vocab_size, 9).tolist()
    outs3 = engine.generate_batch([ext], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert engine.last_stats["prefill_token_area"] < area1
    assert outs3[0]["token_ids"] == naive_greedy(params, cfg, ext, 6)
    _cache_invariant(engine)

    # a diverging prompt (same first page only)
    div = base[:8] + rng.integers(0, cfg.vocab_size, 12).tolist()
    outs4 = engine.generate_batch([div], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 8
    assert outs4[0]["token_ids"] == naive_greedy(params, cfg, div, 6)
    _cache_invariant(engine)


def test_prefix_cache_same_wave(setup):
    """Prompts sharing a prefix INSIDE one batch: the first admission
    registers its pages, later same-round admissions reference them (the
    suffix dispatch ordering makes same-round writer->reader safe)."""
    cfg, params = setup
    rng = np.random.default_rng(37)
    shared = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 3, 7]]
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())

    engine = make_engine(params, cfg)
    outs = engine.generate_batch(prompts, sp)
    assert engine.last_stats["cached_prompt_tokens"] == 2 * 16  # rows 2 and 3
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 5)
    _cache_invariant(engine)


def test_prefix_cache_eviction_under_pressure(setup):
    """A tiny pool forces LRU eviction of parked cache pages: allocation must
    reclaim them (never report dry while the LRU holds pages) and outputs
    stay lossless."""
    cfg, params = setup
    rng = np.random.default_rng(41)
    sp = SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=())
    # 12 pages: two 17-token prompts (3 pages each incl. bucket) + decode room
    engine = make_engine(params, cfg, n_slots=2, n_pages=12)

    batches = [
        [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(2)] for _ in range(3)
    ]
    for batch in batches:
        outs = engine.generate_batch(batch, sp)
        for prompt, out in zip(batch, outs):
            assert out["token_ids"] == naive_greedy(params, cfg, prompt, 4)
        _cache_invariant(engine)
    # distinct prompts kept arriving into a 12-page pool: old entries evicted
    assert len(engine._cache_lru) <= 12


def test_prefix_cache_off(setup):
    cfg, params = setup
    rng = np.random.default_rng(43)
    prompt = rng.integers(0, cfg.vocab_size, 20).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=())
    engine = make_engine(params, cfg, prefix_caching=False)
    outs1 = engine.generate_batch([prompt], sp)
    outs2 = engine.generate_batch([prompt], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 0
    assert not engine._prefix_map
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == naive_greedy(params, cfg, prompt, 4)


def test_prefix_cache_with_spec_decode(setup):
    """Composition with n-gram speculative decoding: the full-hit path skips
    prefill entirely but must still fill the n-gram history (drafts match
    against the prompt), staying lossless."""
    cfg, params = setup
    rng = np.random.default_rng(47)
    seq = rng.integers(0, cfg.vocab_size, 17).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg, speculate_k=3)
    ref = naive_greedy(params, cfg, seq, 8)
    outs1 = engine.generate_batch([seq], sp)
    outs2 = engine.generate_batch([seq], sp)  # full prefix hit
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == ref
    # extension (suffix pass under spec: hist carries the FULL prompt)
    ext = seq[:16] + rng.integers(0, cfg.vocab_size, 6).tolist()
    outs3 = engine.generate_batch([ext], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert outs3[0]["token_ids"] == naive_greedy(params, cfg, ext, 8)
    _cache_invariant(engine)


def test_prefix_cache_with_parallel_sampling(setup):
    """n>1: the leader's prompt pages may come from the cache; siblings
    share them by refcount on top (two sharing layers compose)."""
    cfg, params = setup
    rng = np.random.default_rng(53)
    prompt = rng.integers(0, cfg.vocab_size, 19).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=(), n=2)
    engine = make_engine(params, cfg)
    ref = naive_greedy(params, cfg, prompt, 4)
    outs1 = engine.generate_batch([prompt], sp)
    outs2 = engine.generate_batch([prompt], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 16
    for o in outs1 + outs2:
        assert o["token_ids"] == ref
    _cache_invariant(engine)


def test_prefix_cache_survives_preemption(setup):
    """Preempted requests re-admit through the cache (their prompt pages are
    still registered), and the final outputs stay lossless."""
    cfg, params = setup
    rng = np.random.default_rng(59)
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    # deliberately tight pool (mirrors test_preemption_on_tiny_pool's shape)
    engine = make_engine(params, cfg, n_slots=3, n_pages=9)
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(3)]
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 6)
    _cache_invariant(engine)


# --- chunked prefill (vLLM chunked-prefill role) ----------------------------------


def test_chunked_prefill_lossless(setup):
    """prefill_chunk splits long prompts into per-step pieces; outputs must
    equal the unchunked greedy stream, short prompts are unaffected, and
    decode keeps dispatching between pieces."""
    cfg, params = setup
    rng = np.random.default_rng(71)
    prompts = [
        rng.integers(0, cfg.vocab_size, 40).tolist(),  # 5 pieces at chunk=8
        rng.integers(0, cfg.vocab_size, 5).tolist(),   # unchunked (short)
        rng.integers(0, cfg.vocab_size, 23).tolist(),  # 3 pieces
        rng.integers(0, cfg.vocab_size, 9).tolist(),   # needs exactly 8 positions -> unchunked
    ]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = make_engine(params, cfg, max_context=64, prefill_chunk=8)
    outs = engine.generate_batch(prompts, sp)
    assert engine.last_stats["prefill_pieces"] == 5 + 3
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 6)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_chunked_prefill_interleaves_decode(setup):
    """While a long prompt pieces through prefill, already-running slots keep
    emitting: the long arrival must not convoy the batch."""
    cfg, params = setup
    rng = np.random.default_rng(73)
    sp = SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=())
    engine = make_engine(params, cfg, n_slots=2, max_context=64, prefill_chunk=8)
    short = rng.integers(0, cfg.vocab_size, 4).tolist()
    long = rng.integers(0, cfg.vocab_size, 40).tolist()

    engine.begin_stream(sp)
    engine.add_request(short)
    done = {}
    for rec in engine.step():  # admit + first chunk dispatched for short
        done[rec["request_id"]] = rec
    engine.add_request(long)   # arrives mid-stream; pieces through prefill
    chunk_dispatches_during_prefill = 0
    while not engine.stream_idle:
        was_prefilling = any(s.req is not None and s.prefilling for s in engine._slots)
        before = engine._st.stats["chunk_dispatches"]
        for rec in engine.step():
            done[rec["request_id"]] = rec
        if was_prefilling and engine._st.stats["chunk_dispatches"] > before:
            chunk_dispatches_during_prefill += 1
    engine.end_stream()
    assert chunk_dispatches_during_prefill > 0  # decode ran between pieces
    assert done[0]["outputs"][0]["token_ids"] == naive_greedy(params, cfg, short, 10)
    assert done[1]["outputs"][0]["token_ids"] == naive_greedy(params, cfg, long, 10)


def test_chunked_prefill_with_prefix_cache(setup):
    """Pieces start at the cached length and register pages as they dispatch:
    a second stream over the same long prompt skips already-written pieces."""
    cfg, params = setup
    rng = np.random.default_rng(79)
    long = rng.integers(0, cfg.vocab_size, 40).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())
    engine = make_engine(params, cfg, max_context=64, prefill_chunk=8)
    ref = naive_greedy(params, cfg, long, 5)
    outs1 = engine.generate_batch([long], sp)
    pieces1 = engine.last_stats["prefill_pieces"]
    outs2 = engine.generate_batch([long], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 32  # (40-1)//8 pages
    assert engine.last_stats["prefill_pieces"] < pieces1
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == ref
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_chunked_prefill_preemption_mid_prefill(setup):
    """A pool squeezed mid-prefill preempts the chunking slot; its re-admission
    resumes from the cache-registered pieces and the output is unchanged."""
    cfg, params = setup
    rng = np.random.default_rng(83)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg, n_slots=2, n_pages=8, max_context=64, prefill_chunk=8)
    prompts = [
        rng.integers(0, cfg.vocab_size, 30).tolist(),
        rng.integers(0, cfg.vocab_size, 8).tolist(),
    ]
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 8)
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_chunked_prefill_with_spec_decode(setup):
    """Chunked pieces defer the n-gram history fill to decode admission; the
    speculative stream stays lossless."""
    cfg, params = setup
    rng = np.random.default_rng(89)
    long = rng.integers(0, cfg.vocab_size, 33).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg, max_context=64, prefill_chunk=8, speculate_k=2)
    outs = engine.generate_batch([long], sp)
    assert engine.last_stats["prefill_pieces"] >= 4
    assert outs[0]["token_ids"] == naive_greedy(params, cfg, long, 8)


def test_chunked_prefill_invalid_chunk(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="prefill_chunk"):
        make_engine(params, cfg, prefill_chunk=12)  # not a bucket multiple


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_fuzz_feature_compositions(setup, seed):
    """Fuzz the round-3 serving features TOGETHER: several streams over ONE
    engine, prompts drawn from a small pool of shared stems (forcing prefix
    hits, partial matches, and LRU eviction in a tight page pool), random
    prefill_chunk (piecing long prompts), random chunk/pipeline geometry.
    Every output must equal the naive sequential stream; page accounting must
    balance after every stream."""
    cfg, params = setup
    rng = np.random.default_rng(100 + seed)
    stems = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(9, 33, 3)]
    max_tokens = int(rng.integers(2, 7))
    chunked = bool(rng.random() < 0.5)
    eng = make_engine(
        params, cfg,
        n_slots=int(rng.integers(2, 5)),
        n_pages=int(rng.integers(10, 18)),  # tight: forces eviction + preemption
        max_context=64,
        chunk=int(rng.integers(2, 6)),
        pipeline_depth=int(rng.integers(1, 4)),
        prefill_chunk=8 if chunked else None,
    )
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=())
    # per-request sampling variants that are argmax-equivalent by construction
    # (top_k=1 / top_p->0 truncate to the greedy token), so they fuzz the
    # sampled branch against the same naive oracle
    variants = [
        None,
        SamplingParams(temperature=0.9, top_k=1, max_tokens=max_tokens),
        SamplingParams(temperature=1.4, top_p=1e-9, max_tokens=max_tokens),
    ]
    naive_cache: dict[tuple, list[int]] = {}
    for _stream in range(3):
        prompts = []
        for _ in range(int(rng.integers(2, 7))):
            stem = stems[int(rng.integers(0, len(stems)))]
            cut = int(rng.integers(1, len(stem) + 1))
            ext = rng.integers(1, cfg.vocab_size - 1, int(rng.integers(0, 9))).tolist()
            prompts.append(stem[:cut] + ext)
        reqs = [
            {"prompt": p, "sampling": variants[int(rng.integers(0, len(variants)))]}
            for p in prompts
        ]
        outs = run_stream(eng, sp, reqs, features={"sample", "topk", "topp"})
        for prompt, out in zip(prompts, outs):
            key = tuple(prompt)
            if key not in naive_cache:
                naive_cache[key] = naive_greedy(params, cfg, prompt, max_tokens)
            assert out[0]["token_ids"] == naive_cache[key], (seed, _stream, len(prompt))
        assert len(eng._free_pages) + len(eng._cache_lru) == eng.n_pages
        assert set(eng._page_hash) == set(eng._prefix_map.values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_fuzz_with_cancels(setup, seed):
    """Fuzz host-side cancellation against the composed scheduler (tight pool,
    prefix sharing, chunked prefill, preemption): random requests are
    cancelled at random times mid-stream. Cancelled outputs must be exact
    prefixes of the naive greedy stream with the cancel reason; survivors
    must be bitwise-exact; pages must balance after every stream."""
    cfg, params = setup
    rng = np.random.default_rng(300 + seed)
    stems = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(9, 33, 3)]
    max_tokens = int(rng.integers(4, 9))
    eng = make_engine(
        params, cfg,
        n_slots=int(rng.integers(2, 5)),
        n_pages=int(rng.integers(10, 18)),
        max_context=64,
        chunk=int(rng.integers(2, 6)),
        pipeline_depth=int(rng.integers(1, 4)),
        prefill_chunk=8 if rng.random() < 0.5 else None,
    )
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=())
    naive_cache: dict[tuple, list[int]] = {}
    for _stream in range(3):
        prompts = []
        for _ in range(int(rng.integers(3, 8))):
            stem = stems[int(rng.integers(0, len(stems)))]
            cut = int(rng.integers(1, len(stem) + 1))
            ext = rng.integers(1, cfg.vocab_size - 1, int(rng.integers(0, 9))).tolist()
            prompts.append(stem[:cut] + ext)
        eng.begin_stream(sp)
        ids = [eng.add_request(p) for p in prompts]
        to_cancel = {rid for rid in ids if rng.random() < 0.4}
        keep = {rid: (int(rng.integers(1, max_tokens + 1)) if rng.random() < 0.5 else None)
                for rid in to_cancel}
        got: dict[int, list] = {}
        try:
            for _ in range(500):
                for rec in eng.step():
                    got[rec["request_id"]] = rec["outputs"]
                for rid in list(to_cancel):
                    if rid not in got and rng.random() < 0.3:
                        eng.cancel_request(rid, keep_tokens=keep[rid], finish_reason="abort")
                        to_cancel.discard(rid)
                if len(got) == len(ids) and eng.stream_idle:
                    break
        finally:
            eng.end_stream()
        assert len(got) == len(ids), (seed, _stream)
        for rid, prompt in zip(ids, prompts):
            key = tuple(prompt)
            if key not in naive_cache:
                naive_cache[key] = naive_greedy(params, cfg, prompt, max_tokens)
            out = got[rid][0]
            if out["finish_reason"] == "abort":
                want = naive_cache[key][: keep.get(rid)] if keep.get(rid) is not None else naive_cache[key]
                assert out["token_ids"] == want[: len(out["token_ids"])], (seed, _stream, rid)
            else:  # completed before (or without) the cancel
                assert out["token_ids"] == naive_cache[key], (seed, _stream, rid)
        assert len(eng._free_pages) + len(eng._cache_lru) == eng.n_pages
        assert set(eng._page_hash) == set(eng._prefix_map.values())


# --- per-request sampling params (vLLM's per-request SamplingParams surface) ---------


def run_stream(engine, sp, reqs, features=None, key=None):
    """Drive one stream: reqs is a list of add_request kwargs dicts; returns
    each request's outputs list, in submission order."""
    engine.begin_stream(sp, key=key, features=features)
    ids = [engine.add_request(**r) for r in reqs]
    got = {}
    try:
        while not engine.stream_idle:
            for rec in engine.step():
                got[rec["request_id"]] = rec["outputs"]
    finally:
        engine.end_stream()
    return [got[i] for i in ids]


def test_per_request_greedy_exact_in_sampling_stream(setup):
    """A stream compiled with sampling branches serves default (greedy)
    requests bitwise-greedy: the runtime cond keeps the argmax path exact."""
    cfg, params = setup
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 9, 13]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = run_stream(engine, sp, [{"prompt": p} for p in prompts],
                      features={"sample", "topk", "topp"})
    for p, out in zip(prompts, outs):
        assert out[0]["token_ids"] == naive_greedy(params, cfg, p, 6)


def test_per_request_topk1_and_tiny_topp_equal_greedy(setup):
    """temperature>0 with top_k=1 (or top_p→0) truncates the distribution to
    the argmax token — the sampled stream must equal greedy token-for-token."""
    cfg, params = setup
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    want = naive_greedy(params, cfg, prompt, 6)
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = run_stream(
        engine, sp,
        [
            {"prompt": prompt, "sampling": SamplingParams(temperature=0.9, top_k=1, max_tokens=6)},
            {"prompt": prompt, "sampling": SamplingParams(temperature=1.3, top_p=1e-9, max_tokens=6)},
        ],
        features={"sample", "topk", "topp"},
    )
    assert outs[0][0]["token_ids"] == want
    assert outs[1][0]["token_ids"] == want


def test_per_request_mixed_traffic_greedy_rows_exact(setup):
    """Greedy and sampled requests share the batch; the greedy rows' outputs
    are unaffected by their sampled neighbours."""
    cfg, params = setup
    rng = np.random.default_rng(23)
    g_prompt = rng.integers(0, cfg.vocab_size, 7).tolist()
    s_prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = run_stream(
        engine, sp,
        [
            {"prompt": g_prompt},
            {"prompt": s_prompt, "sampling": SamplingParams(temperature=1.0, max_tokens=8)},
        ],
        features={"sample"},
    )
    assert outs[0][0]["token_ids"] == naive_greedy(params, cfg, g_prompt, 8)
    assert len(outs[1][0]["token_ids"]) == 8


def test_per_request_seed_reproducible_and_scheduling_invariant(setup):
    """Same (stream key, seed, prompt) => same sampled tokens, whatever else
    is in the batch (position-keyed PRNG); different seeds diverge."""
    cfg, params = setup
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    other = rng.integers(0, cfg.vocab_size, 11).tolist()
    samp = SamplingParams(temperature=1.0, max_tokens=10)
    sp = SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=())
    engine = make_engine(params, cfg)
    solo = run_stream(engine, sp, [{"prompt": prompt, "sampling": samp, "seed": 7}],
                      features={"sample"}, key=jax.random.key(3))
    crowded = run_stream(
        engine, sp,
        [
            {"prompt": other},
            {"prompt": prompt, "sampling": samp, "seed": 7},
            {"prompt": prompt, "sampling": samp, "seed": 8},
        ],
        features={"sample"}, key=jax.random.key(3),
    )
    assert crowded[1][0]["token_ids"] == solo[0][0]["token_ids"]
    assert crowded[2][0]["token_ids"] != solo[0][0]["token_ids"]


def test_per_request_sampling_survives_preemption(setup):
    """Preemption + recompute redraws the identical sampled continuation: the
    PRNG is keyed by (stream key, request seed, position), not by scheduling."""
    cfg, params = setup
    rng = np.random.default_rng(25)
    # 3 slots x (17-token prompt -> 3 pages) fill the 9-page pool exactly;
    # max_tokens=10 pushes every sequence past the 24-token page boundary, so
    # each slot needs a 4th page and the scheduler must preempt
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(3)]
    samp = SamplingParams(temperature=1.0, max_tokens=10)
    sp = SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=())
    reqs = [{"prompt": p, "sampling": samp, "seed": 100 + i} for i, p in enumerate(prompts)]
    ample = make_engine(params, cfg, n_slots=3, n_pages=64)
    want = run_stream(ample, sp, reqs, features={"sample"}, key=jax.random.key(9))
    tight = make_engine(params, cfg, n_slots=3, n_pages=9)  # forces preemption
    got = run_stream(tight, sp, reqs, features={"sample"}, key=jax.random.key(9))
    assert tight.last_stats["preemptions"] > 0
    for w, g in zip(want, got):
        assert g[0]["token_ids"] == w[0]["token_ids"]
    assert len(tight._free_pages) + len(tight._cache_lru) == tight.n_pages


def test_per_request_penalties_match_stream_level(setup):
    """Per-request penalty params produce the same (deterministic, greedy)
    outputs as a stream whose default SamplingParams carries them."""
    cfg, params = setup
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, cfg.vocab_size, 7).tolist() for _ in range(2)]
    pen = SamplingParams(temperature=0.0, max_tokens=8, repetition_penalty=1.4,
                         presence_penalty=0.3, frequency_penalty=0.2)
    engine = make_engine(params, cfg)
    stream_level = engine.generate_batch(prompts, pen)
    plain = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    per_request = run_stream(engine, plain,
                             [{"prompt": p, "sampling": pen} for p in prompts],
                             features={"pen"})
    for sl, pr in zip(stream_level, per_request):
        assert pr[0]["token_ids"] == sl["token_ids"]
        assert pr[0]["cumulative_logprob"] == pytest.approx(sl["cumulative_logprob"], rel=1e-5)


def test_per_request_n_gang(setup):
    """Per-request n queues a gang even when the stream default is n=1; greedy
    siblings all reproduce the solo output."""
    cfg, params = setup
    rng = np.random.default_rng(27)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())
    engine = make_engine(params, cfg)
    want = naive_greedy(params, cfg, prompt, 5)
    outs = run_stream(engine, sp,
                      [{"prompt": prompt, "sampling": SamplingParams(n=3, max_tokens=5)}])
    assert len(outs[0]) == 3
    for o in outs[0]:
        assert o["token_ids"] == want


def test_per_request_n_sampled_siblings_differ(setup):
    """n>1 with temperature>0: siblings draw from per-sequence seeds."""
    cfg, params = setup
    rng = np.random.default_rng(28)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = run_stream(
        engine, sp,
        [{"prompt": prompt, "sampling": SamplingParams(n=4, temperature=1.0, max_tokens=8)}],
        features={"sample"},
    )
    seqs = [tuple(o["token_ids"]) for o in outs[0]]
    assert len(outs[0]) == 4 and len(set(seqs)) > 1


def test_per_request_feature_rejection(setup):
    """A request needing a branch the stream did not compile fails fast with
    a clear error instead of recompiling mid-stream."""
    cfg, params = setup
    sp = SamplingParams(temperature=0.0, max_tokens=4, stop_token_ids=())
    engine = make_engine(params, cfg)
    engine.begin_stream(sp)  # greedy-only program
    try:
        with pytest.raises(ValueError, match="features"):
            engine.add_request([1, 2, 3], sampling=SamplingParams(temperature=0.8, max_tokens=4))
        with pytest.raises(ValueError, match="Unknown sampling features"):
            engine.end_stream()
            engine.begin_stream(sp, features={"bogus"})
    finally:
        engine.end_stream()


def test_per_request_sampling_max_tokens_budget(setup):
    """sampling.max_tokens acts as the per-request budget when max_tokens is
    not passed explicitly."""
    cfg, params = setup
    rng = np.random.default_rng(29)
    prompt = rng.integers(0, cfg.vocab_size, 6).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=())
    engine = make_engine(params, cfg)
    outs = run_stream(engine, sp, [{"prompt": prompt, "sampling": SamplingParams(max_tokens=3)}])
    assert len(outs[0][0]["token_ids"]) == 3
    assert outs[0][0]["finish_reason"] == "length"


def test_admission_order_sjf_ljf(setup):
    """Queue discipline: with one slot, jobs run serially in admission order —
    sjf completes shortest-estimate requests first, ljf longest-first, and
    both return the same greedy tokens as fifo (scheduling-invariant)."""
    cfg, params = setup
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab_size, 5).tolist()
    budgets = [6, 2, 4]  # same prompt -> estimate ordering is the budget ordering
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())

    def drive(order):
        engine = make_engine(params, cfg, n_slots=1, admission_order=order)
        engine.begin_stream(sp)
        ids = [engine.add_request(list(prompt), max_tokens=b) for b in budgets]
        finished = []
        try:
            while not engine.stream_idle:
                for rec in engine.step():
                    finished.append(rec["request_id"])
        finally:
            engine.end_stream()
        return ids, finished

    ids, finished = drive("sjf")
    assert finished == [ids[1], ids[2], ids[0]]  # budgets 2, 4, 6
    ids, finished = drive("ljf")
    assert finished == [ids[0], ids[2], ids[1]]  # budgets 6, 4, 2
    ids, finished = drive("fifo")
    assert finished == ids

    # tokens are policy-invariant (greedy; per-request budget caps length)
    outs = {}
    for order in ("fifo", "sjf", "ljf"):
        engine = make_engine(params, cfg, n_slots=1, admission_order=order)
        outs[order] = run_stream(
            engine, sp, [{"prompt": list(prompt), "max_tokens": b} for b in budgets]
        )
    for o in ("sjf", "ljf"):
        for a, b in zip(outs["fifo"], outs[o]):
            assert a[0]["token_ids"] == b[0]["token_ids"]


def test_admission_order_requeued_front_priority(setup):
    """Sorted admission never jumps ahead of preempted / gang-split work parked
    at the queue front (it holds in-progress output and must resume first)."""
    cfg, params = setup
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    engine = make_engine(params, cfg, admission_order="sjf")
    engine.begin_stream(sp)
    try:
        st = engine._st
        # long job queued first, then a requeued (preempted) job parked at front
        engine.add_request([1, 2, 3, 4, 5], max_tokens=8)
        from ssi_jax.generate.paged_engine import _Request

        preempted = _Request(idx=999, prompt=[7] * 5, max_tokens=8, requeued=True)
        st.queue.insert(0, [preempted])
        # a brand-new tiny job sorts ahead of the long one but NOT the requeued
        engine.add_request([1], max_tokens=1)
        assert st.queue[0][0] is preempted
        assert st.queue[1][0].prompt == [1]
        assert st.queue[2][0].prompt == [1, 2, 3, 4, 5]
        st.queue.clear()  # hand-crafted entries must not reach admission
        st.expected.clear()
    finally:
        engine.end_stream()


def test_admission_order_rejects_unknown(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="admission_order"):
        make_engine(params, cfg, admission_order="lifo")


def test_spec_decode_per_request_budget_no_cross_corruption(setup):
    """The device-side draft-write cap must use the PER-REQUEST token budget.

    A spec request admitted with max_tokens far below the stream's gets pages
    provisioned only up to prompt + its own budget; a stream-level device cap
    would let draft K/V write through the slot's stale page-table tail
    (entries left by the slot's previous occupant, re-allocated to concurrent
    requests) and corrupt a neighbor's KV pages. Choreography: a long request
    warms slot page-table tails, then short-budget requests share the stream
    with long-budget victims; every output must equal the sequential oracle.
    """
    cfg, params = setup
    rng = np.random.default_rng(23)
    engine = make_engine(params, cfg, n_slots=2, speculate_k=3, n_pages=18)
    sp = SamplingParams(temperature=0.0, max_tokens=40, stop_token_ids=())

    engine.begin_stream(sp)
    # wave 1: fill both slots' page-table rows deep (prompt 17 + 40 tokens
    # -> cap 57 -> 8 pages of 8), then let them finish and free their pages
    long_prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(2)]
    ids = [engine.add_request(p) for p in long_prompts]
    # wave 2: short-budget requests (stale tail beyond 2 provisioned pages)
    # interleaved with full-budget victims whose pages reuse wave 1's frees
    short_prompts = [rng.integers(0, cfg.vocab_size, 9).tolist() for _ in range(2)]
    victim_prompts = [rng.integers(0, cfg.vocab_size, 11).tolist() for _ in range(2)]
    ids += [engine.add_request(short_prompts[0], max_tokens=3)]
    ids += [engine.add_request(victim_prompts[0])]
    ids += [engine.add_request(short_prompts[1], max_tokens=2)]
    ids += [engine.add_request(victim_prompts[1])]
    done = {}
    for _ in range(400):
        for rec in engine.step():
            done[rec["request_id"]] = rec["outputs"][0]
        if len(done) == len(ids):
            break
    engine.end_stream()

    want = {
        0: (long_prompts[0], 40), 1: (long_prompts[1], 40),
        2: (short_prompts[0], 3), 3: (victim_prompts[0], 40),
        4: (short_prompts[1], 2), 5: (victim_prompts[1], 40),
    }
    assert len(done) == len(ids)
    for rid, (prompt, mt) in want.items():
        assert done[rid]["token_ids"] == naive_greedy(params, cfg, prompt, mt), f"rid {rid}"
    assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages


def test_spec_decode_stale_page_table_tail_never_written(setup):
    """Draft K/V writes must stop at the PER-REQUEST provisioning cap.

    A slot's host page-table row keeps stale tail entries from its previous
    occupant; pages they point at may belong to another live request. The
    first verify step writes T=8 draft positions from prompt-1, so a request
    with max_tokens=1 (2 provisioned pages) reaches positions 16..21 — page
    index 2, a stale entry here pointed at a sentinel-filled page. A device
    cap derived from the STREAM budget (40) would write through it.
    """
    import jax

    cfg, params = setup
    engine = make_engine(params, cfg, n_slots=1, speculate_k=7, n_pages=10)
    sp = SamplingParams(temperature=0.0, max_tokens=40, stop_token_ids=())

    victim = 7  # owned by "someone else": out of the free list, sentinel-filled
    engine._free_pages.remove(victim)
    rows = jnp.asarray([l * engine.n_pages + victim for l in range(cfg.num_layers)])
    for key in ("k", "v"):
        engine.pools[key] = engine.pools[key].at[rows].set(7.0)
    engine._page_table[0, 2:] = victim  # stale tail beyond the 2 provisioned pages

    engine.begin_stream(sp)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, 15).tolist()
    rid = engine.add_request(prompt, max_tokens=1)  # cap = max(16, 15+1) = 16
    done = {}
    for _ in range(50):
        for rec in engine.step():
            done[rec["request_id"]] = rec["outputs"][0]
        if done:
            break
    engine.end_stream()

    assert done[rid]["token_ids"] == naive_greedy(params, cfg, prompt, 1)
    for key in ("k", "v"):
        got = np.asarray(jax.device_get(engine.pools[key]))[np.asarray(rows)]
        assert np.all(got == 7.0), f"{key} pool: stale-table page written past the request cap"
