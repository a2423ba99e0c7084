"""Serving latency under dynamic arrivals: TTFT / TPOT percentiles, chunked
prefill on vs off.

Drives the incremental API the way a server would: requests arrive over time
(deterministic stagger — no wall-clock randomness), each step() harvests
completions, and per-request timing comes from the engine's observability
metrics. The interesting contrast is a stream of short interactive requests
with occasional LONG prompts: unchunked, every long arrival stalls all slots
for its full prefill (TTFT/TPOT tail); chunked, the long prefill pieces
through while short requests keep decoding.

Run from the repo root:
python tools/bench_latency.py
"""
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import ssi_jax  # noqa: E402,F401  (the package's one compile-cache location)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

import numpy as np

from bench_decode import _model
from ssi_jax.generate.engine import SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine

MAX_TOKENS = 64
N_SHORT = 64
N_LONG = 8
LONG_LEN = 1024
SLOTS = 16


def run(prefill_chunk):
    cfg, params = _model()
    rng = np.random.default_rng(17)
    shorts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in rng.integers(40, 120, N_SHORT)]
    longs = [rng.integers(0, cfg.vocab_size, LONG_LEN).tolist() for _ in range(N_LONG)]
    # interleave: one long every 8 shorts
    arrivals = []
    li = iter(longs)
    for i, s in enumerate(shorts):
        arrivals.append(s)
        if (i + 1) % 8 == 0:
            arrivals.append(next(li))
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=())

    engine = PagedDecodeEngine(
        params, cfg, pad_id=133_006, n_slots=SLOTS,
        max_context=LONG_LEN + MAX_TOKENS,
        prefill_chunk=prefill_chunk, prefix_caching=False,  # isolate the chunking effect
    )
    # warmup/compile: full workload once
    engine.generate_batch(arrivals[: SLOTS + 2], sp)

    submit_t = {}
    first_t = {}
    done_t = {}
    sizes = {}
    engine.begin_stream(sp)
    pending = list(arrivals)
    step_i = 0
    while pending or not engine.stream_idle:
        # feed 2 requests per scheduler step (arrival pressure > service rate
        # early on, so the queue exercises admission competition)
        for _ in range(2):
            if pending:
                prm = pending.pop(0)
                rid = engine.add_request(prm)
                submit_t[rid] = time.perf_counter()
                sizes[rid] = len(prm)
        for rec in engine.step():
            done_t[rec["request_id"]] = time.perf_counter()
        # first-token time approximation: a request's slot emitted its first
        # token when its slot shows output; cheap probe via engine internals
        for sid, s in enumerate(engine._slots):
            if s.req is not None and s.n_out > 0 and s.req.idx not in first_t:
                first_t[s.req.idx] = time.perf_counter()
        step_i += 1
    engine.end_stream()

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else None

    ttft = [first_t[r] - submit_t[r] for r in first_t]
    e2e = [done_t[r] - submit_t[r] for r in done_t]
    short_ttft = [first_t[r] - submit_t[r] for r in first_t if sizes[r] < 200]
    return {
        "prefill_chunk": prefill_chunk,
        "steps": step_i,
        "ttft_p50_ms": round(1e3 * pct(ttft, 50), 1),
        "ttft_p99_ms": round(1e3 * pct(ttft, 99), 1),
        "short_ttft_p99_ms": round(1e3 * pct(short_ttft, 99), 1),
        "e2e_p50_ms": round(1e3 * pct(e2e, 50), 1),
        "e2e_p99_ms": round(1e3 * pct(e2e, 99), 1),
    }


if __name__ == "__main__":
    out = {"off": run(None), "chunk_256": run(256)}
    print(json.dumps(out))
