"""Prefix-caching A/B on hardware: shared-system-prompt serving workload.

96 requests = a 256-token shared system prompt + ragged 32..128-token unique
tails (the shape of templated generation: ssi_jax/templates/*.jinja put the
instruction block before the per-sample DSU payload). With prefix_caching on,
admissions after the first reference the 2 cached prompt pages and prefill
only the tail bucket; off = every admission prefills its full bucket.

Reports tok/s, prefill_token_area (padded prefill work actually dispatched),
and cached_prompt_tokens. Sequence agreement below 1.0 vs caching-off is
random-weight bf16 argmax-tie noise, not a caching defect — the CPU f32 suite
asserts exact losslessness. Run from the repo root:
python tools/bench_prefix_cache.py
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

from bench_decode import SLOTS, _model
from ssi_jax.generate.engine import SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine

MAX_TOKENS = 128

cfg, params = _model()
rng = np.random.default_rng(11)
system = rng.integers(0, cfg.vocab_size, 256).tolist()
prompts = [
    system + rng.integers(0, cfg.vocab_size, int(n)).tolist()
    for n in rng.integers(32, 129, 96)
]
stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, cfg.vocab_size // 100, replace=False))
sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)

results = {}
for caching in [False, True]:
    engine = PagedDecodeEngine(
        params, cfg, pad_id=133_006, n_slots=SLOTS,
        max_context=max(len(p) for p in prompts) + MAX_TOKENS,
        prefix_caching=caching,
    )
    outs = engine.generate_batch(prompts, sp)  # compile + warmup
    best, st = 0.0, None
    for _ in range(3):
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, sp)
        dt = time.perf_counter() - t0
        total = sum(len(o["token_ids"]) for o in outs)
        if total / dt > best:
            best, st = total / dt, dict(engine.last_stats)
    results["on" if caching else "off"] = {
        "tok_s": round(best, 1),
        "total_tokens": total,
        "prefill_token_area": st["prefill_token_area"],
        "prefill_dispatches": st["prefill_dispatches"],
        "cached_prompt_tokens": st["cached_prompt_tokens"],
        "tokens": [o["token_ids"] for o in outs],
    }
    print("caching", caching, {k: v for k, v in results["on" if caching else "off"].items() if k != "tokens"}, flush=True)

agree = sum(
    a == b for a, b in zip(results["off"]["tokens"], results["on"]["tokens"])
) / len(prompts)
for r in results.values():
    del r["tokens"]
results["exact_sequence_agreement"] = agree  # bf16 tie-noise bound on random weights
results["speedup"] = round(results["on"]["tok_s"] / results["off"]["tok_s"], 3)
print(json.dumps(results))
