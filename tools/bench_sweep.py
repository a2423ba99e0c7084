#!/usr/bin/env python
"""Perf sweep over (micro-batch, accum, remat policy, CE chunk) at the headline
CPT workload (49,152-token optimizer window, 1B extended-vocab, bf16).

Each config is compiled and timed on the GPU; results print as JSONL so a run
can be tailed/interrupted. Use --only to run a subset by name.
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

SEQ = 768
WINDOW_TOKENS = 4 * 16 * SEQ  # 49,152 — the reference default (bs16 x accum4)

# name: (batch, accum, remat, chunk)
CONFIGS = {
    "baseline_b16a4_full": (16, 4, "full", 1024),
    "b16a4_save_qkv": (16, 4, "save_qkv", 1024),
    "b8a8_save_qkv": (8, 8, "save_qkv", 1024),
    "b4a16_save_qkv_mlp": (4, 16, "save_qkv_mlp", 1024),
    "b4a16_save_qkv_mlp_c3072": (4, 16, "save_qkv_mlp", 3072),
    "b8a8_save_qkv_mlp": (8, 8, "save_qkv_mlp", 2048),
    "b8a8_save_mlp": (8, 8, "save_mlp", 2048),
    "b4a16_none": (4, 16, "none", 3072),
    "b2a32_save_qkv_mlp_c1536": (2, 32, "save_qkv_mlp", 1536),
    "b2a32_none_c1536": (2, 32, "none", 1536),
    "b8a8_save_qkv_c3072": (8, 8, "save_qkv", 3072),
    "b4a16_save_mlp_c3072": (4, 16, "save_mlp", 3072),
    # larger micro-batches halve the per-step weight streaming (accum x ~3
    # weight reads/step), if they still fit device memory
    "b8a8_save_qkv_mlp_c3072": (8, 8, "save_qkv_mlp", 3072),
    "b16a4_save_qkv_mlp_c3072": (16, 4, "save_qkv_mlp", 3072),
    "b8a8_save_qkv_mlp_attn_c3072": (8, 8, "save_qkv_mlp_attn", 3072),
    "b4a16_save_qkv_mlp_attn_c3072": (4, 16, "save_qkv_mlp_attn", 3072),
    "b16a4_save_qkv_mlp_attn_c3072": (16, 4, "save_qkv_mlp_attn", 3072),
    # leaner-residual large-micro-batch variants: trade saved-mlp residuals
    # for accum/weight-streaming amortization
    "b16a4_save_qkv_c3072": (16, 4, "save_qkv", 3072),
    "b8a8_save_qkv_mlp_c2048": (8, 8, "save_qkv_mlp", 2048),
    # attention backend A/B at the headline window
    "b4a16_xla_attn": (4, 16, "save_qkv_mlp", 3072, "xla"),
    "b4a16_cudnn_attn": (4, 16, "save_qkv_mlp", 3072, "cudnn"),
}


def run_one(name, batch, accum, remat, chunk, impl="auto", steps=6):
    """Thin wrapper over bench._measure (the single source of truth for the
    model/mesh/opt/step setup, warmup count, and timing)."""
    import jax

    import bench

    assert batch * accum * SEQ == WINDOW_TOKENS, (batch, accum)
    t0 = time.perf_counter()
    tps_chip = bench._measure((batch, accum, SEQ, remat, chunk, impl), steps=steps)  # tokens/s/CHIP
    wall = time.perf_counter() - t0
    n_chips = jax.device_count()
    return {"name": name, "batch": batch, "accum": accum, "remat": remat, "chunk": chunk,
            "tokens_per_sec_per_chip": round(tps_chip, 1),
            "step_ms": round(WINDOW_TOKENS / (tps_chip * n_chips) * 1000, 1),
            "wall_s": round(wall, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, help="config names to run")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    names = args.only or list(CONFIGS)
    for name in names:
        batch, accum, remat, chunk, *impl = CONFIGS[name]
        try:
            res = run_one(name, batch, accum, remat, chunk, *impl, steps=args.steps)
        except Exception as e:  # OOM configs are expected — record and continue
            res = {"name": name, "error": f"{type(e).__name__}: {str(e)[:300]}"}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
