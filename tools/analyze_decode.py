#!/usr/bin/env python
"""Decode-path attribution: where does paged-engine wall time go?

Runs the serving-shape ragged workload (same as bench.py's paged extra) once
for warmup/compile and once measured, then prints the engine's last_stats —
prefill vs chunk dispatch counts, host-blocking time per phase, slot occupancy.
Use this before touching the engine: the split between prefill work, decode
chunks, and host sync decides which lever matters.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import ssi_jax  # noqa: E402,F401  (the package's one compile-cache location)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

import jax.numpy as jnp
import numpy as np

from ssi_jax.generate.engine import SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine
from ssi_jax.models.configs import MODEL_CONFIGS, configllama3_2_1b
from ssi_jax.models.llama3 import init_params


def main() -> None:
    kwargs = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kwargs[k] = int(v) if v.isdigit() else v
    cfg = MODEL_CONFIGS[kwargs.pop("model")].copy() if "model" in kwargs else configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    max_tokens = 256
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128_000, int(n)).tolist() for n in rng.integers(50, 700, 96)]
    stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, cfg.vocab_size // 100, replace=False))
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=stops)
    engine = PagedDecodeEngine(
        params, cfg, pad_id=133_006, n_slots=kwargs.pop("n_slots", 48),
        max_context=max(len(p) for p in prompts) + max_tokens, **kwargs,
    )
    engine.generate_batch(prompts, sp)  # warmup/compile
    best = None
    for _ in range(3):
        outs = engine.generate_batch(prompts, sp)
        s = dict(engine.last_stats)
        if best is None or s["wall_s"] < best["wall_s"]:
            best = s
    s = best
    s["tok_s"] = round(s["tokens_out"] / s["wall_s"], 1)
    s["other_block_s"] = round(
        s["wall_s"] - s["dispatch_block_s"] - s["prefill_block_s"] - s["harvest_block_s"], 3
    )
    for k in ("wall_s", "dispatch_block_s", "prefill_block_s", "harvest_block_s", "slot_occupancy"):
        s[k] = round(s[k], 3)
    print(json.dumps(s, indent=1))


if __name__ == "__main__":
    main()
