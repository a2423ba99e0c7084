#!/usr/bin/env python
"""Decode occupancy-tail sweep.

The suspected residual between paged decode and its byte-priced roofline is
host-side — per-dispatch round trips and the ragged drain once the admission
queue empties (96 requests into 96 slots = zero refills; every finished slot
idles until the longest generation completes).

This sweeps the three levers against that diagnosis, same workload generator
as bench_decode.py:

- ``chunk``: decode steps per dispatch — fewer dispatches, more mid-chunk
  waste after a stop token.
- ``pipeline_depth``: in-flight chunks — hides the harvest/dispatch RTT.
- ``n_requests``: 96 (the standard drain-limited batch) vs 4x96 (refill-aware:
  a server under load; finished slots refill from the queue so occupancy holds
  until the true tail).

Usage: python tools/bench_tail.py [--quant int8] [--out chiprun_out/bench_tail.json]
"""

import argparse
import itertools
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
SLOTS = 96


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--requests", type=int, nargs="+", default=[96, 384])
    ap.add_argument("--quant", default=None, choices=[None, "int8"])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from bench_decode import decode_roofline, measure_hbm_bw
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.configs import configllama3_2_1b
    from ssi_jax.models.llama3 import init_params

    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    hbm_bw = measure_hbm_bw()
    print(json.dumps({"hbm_bw_gbs": round(hbm_bw / 1e9, 1)}), flush=True)

    rows = []
    for chunk, depth, n_req in itertools.product(args.chunks, args.depths, args.requests):
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 128_000, int(n)).tolist() for n in rng.integers(50, 700, n_req)]
        stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, cfg.vocab_size // 100, replace=False))
        sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)
        engine = PagedDecodeEngine(
            params, cfg, pad_id=133_006, n_slots=SLOTS,
            max_context=max(len(p) for p in prompts) + MAX_TOKENS,
            chunk=chunk, pipeline_depth=depth, quantize=args.quant,
        )
        engine.generate_batch(prompts, sp)  # compile + warmup
        best, stats = 0.0, {}
        for _ in range(args.runs):
            t0 = time.perf_counter()
            outs = engine.generate_batch(prompts, sp)
            dt = time.perf_counter() - t0
            tok_s = sum(len(o["token_ids"]) for o in outs) / dt
            if tok_s > best:
                best, stats = tok_s, dict(engine.last_stats)
        roof = decode_roofline(stats, best, hbm_bw, chunk, SLOTS)
        row = {"chunk": chunk, "depth": depth, "n_requests": n_req,
               "quant": args.quant, "tok_s": round(best, 1), **roof}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del engine

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"metric": "decode_tail_sweep_1b", "slots": SLOTS,
                       "hbm_bw_gbs": round(hbm_bw / 1e9, 1), "rows": rows}, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
