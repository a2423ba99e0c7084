#!/usr/bin/env python
"""Sweep paged-engine slot count on the bench_decode ragged workload (1B).

The decode roofline bound itself scales with slots: each chunk dispatch
streams the full weight stack once, so more active slots amortize the same
weight bytes over more tokens. This sweep asks which slot count the serving
config should use for the 96-request
ragged workload, or whether occupancy decay (ragged finish times with an empty
refill queue) eats the amortization.

Prints one JSON line per slot count: tok/s + roofline fields.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import ssi_jax  # noqa: E402,F401  (the package's one compile-cache location)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

import jax.numpy as jnp
import numpy as np

MAX_TOKENS = 256
CHUNK = 16


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, nargs="+", default=[48, 64, 96])
    ap.add_argument("--chunk", type=int, nargs="+", default=[CHUNK])
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--quantize", default=None)
    ap.add_argument("--model", default="llama3_2_1b")
    args = ap.parse_args()

    from bench_decode import _ragged_workload, measure_hbm_bw
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.configs import MODEL_CONFIGS
    from ssi_jax.models.llama3 import init_params

    cfg = MODEL_CONFIGS[args.model].copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True

    hbm_bw = measure_hbm_bw()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    prompts, stops = _ragged_workload(cfg)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)
    max_context = max(len(p) for p in prompts) + MAX_TOKENS

    configs = [(s, c) for s in args.slots for c in args.chunk]
    for n_slots, chunk in configs:
        kw = {} if args.depth is None else {"pipeline_depth": args.depth}
        engine = PagedDecodeEngine(
            params, cfg, pad_id=133_006, n_slots=n_slots,
            max_context=max_context, quantize=args.quantize, chunk=chunk, **kw,
        )
        engine.generate_batch(prompts, sp)  # compile + warmup
        best, stats = 0.0, {}
        for _ in range(args.runs):
            t0 = time.perf_counter()
            outs = engine.generate_batch(prompts, sp)
            dt = time.perf_counter() - t0
            total = sum(len(o["token_ids"]) for o in outs)
            if total / dt > best:
                best = total / dt
                stats = dict(engine.last_stats)
        bytes_total = stats.get("weight_bytes", 0.0) + stats.get("kv_bytes", 0.0)
        bound = stats["tokens_out"] / (bytes_total / hbm_bw) if bytes_total else None
        print(json.dumps({
            "slots": n_slots,
            "chunk": chunk,
            "quantize": args.quantize,
            "tok_s": round(best, 1),
            "bound_tok_s": round(bound, 1) if bound else None,
            "ratio_to_bound": round(bound / best, 2) if bound else None,
            "occupancy": round(stats.get("slot_occupancy", 0.0), 3),
            "weight_gb": round(stats.get("weight_bytes", 0.0) / 1e9, 2),
            "kv_gb": round(stats.get("kv_bytes", 0.0) / 1e9, 2),
            "wall_s": round(stats.get("wall_s", 0.0), 3),
            "tokens": stats.get("tokens_out"),
        }), flush=True)
        del engine


if __name__ == "__main__":
    main()
