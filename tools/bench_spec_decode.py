"""Speculative-decode A/B on hardware: k=0 vs k=3 on the ragged bench workload.

Reports tok/s, tokens-per-verify (acceptance), and exact-sequence agreement
with the k=0 stream. NB on bench_decode's RANDOM-weight workload the n-gram
drafter rarely hits and the per-step t_q=4 verify costs extra attention and
logits work. Spec decode is an opt-in for repetitive real text (ASR
transcripts), not the serving default. Agreement < 1.0 here is bf16
argmax-tie noise on random weights; losslessness is proven in f32 by
tests/test_paged_decode.py.

Run from the repo root:
python tools/bench_spec_decode.py
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
from bench_decode import _model, _ragged_workload, MAX_TOKENS, SLOTS
from ssi_jax.generate.engine import SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine

cfg, params = _model()
prompts, stops = _ragged_workload(cfg)
sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)

results = {}
base_tok = None
for k in [0, 3]:
    engine = PagedDecodeEngine(
        params, cfg, pad_id=133_006, n_slots=SLOTS,
        max_context=max(len(p) for p in prompts) + MAX_TOKENS,
        speculate_k=k,
    )
    outs = engine.generate_batch(prompts, sp)  # compile + warmup
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, sp)
        dt = time.perf_counter() - t0
        total = sum(len(o["token_ids"]) for o in outs)
        best = max(best, total / dt)
    toks = [o["token_ids"] for o in outs]
    if k == 0:
        base_tok = toks
    st = engine.last_stats
    results[f"k{k}"] = {
        "tok_s": round(best, 1),
        "total": total,
        "tokens_per_verify": round(st.get("tokens_per_verify", 1.0), 2) if st else None,
        "match_vs_k0": None if base_tok is None else sum(a == b for a, b in zip(base_tok, toks)) / len(toks),
    }
    print(k, results[f"k{k}"], flush=True)
print(json.dumps(results))
