#!/usr/bin/env python
"""Decode throughput benchmark: greedy generation at the 1B eval shapes.

Not the driver headline metric (bench.py is); measures the generation pipeline
the reference runs through vLLM (ref: conf/generate.yaml:17,21-31). Prints one
JSON line with three numbers:

- ``dense_b8``: the reference eval shape (batch 8, uniform ~256-token decode)
  on the fixed-batch dense-cache engine.

- ``dense_b32_ragged`` / ``paged_b48_ragged``: 96 requests whose generation
  lengths vary (a 1%-of-vocab stop set over random weights gives ~geometric
  lengths, the shape of real ASR eval traffic). The dense engine convoys: each
  32-row batch waits for its slowest row. The paged continuous-batching engine
  refills finished slots from the queue. Outputs are greedy and bitwise-
  comparable across engines, so tokens/s is an apples-to-apples ratio
  (``paged_vs_dense_ragged``).

Every time is a host clock around work that ends on the host (``block_until_ready``
or the engine's harvest); repeated runs report the median and the spread.
"""

import json
import os
import time

import jax

import ssi_jax  # noqa: F401  (the package's one compile-cache location)

import jax.numpy as jnp
import numpy as np

MAX_TOKENS = 256
N_RAGGED = 96
SLOTS = 96  # one slot per request of the 96-request ragged workload: each decode
# step streams the full weight stack once, so more active slots amortize the
# same weight bytes over more tokens (not yet re-swept on the H100)
CHUNK = 16  # engine default decode steps per dispatch (PagedDecodeEngine.chunk)
DENSE_BATCH = 32


def _model():
    from ssi_jax.models.configs import configllama3_2_1b
    from ssi_jax.models.llama3 import init_params

    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    return cfg, params


def bench_dense_b8(cfg, params):
    from ssi_jax.generate.engine import DecodeEngine, SamplingParams

    engine = DecodeEngine(params, cfg, pad_id=133_006)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in rng.integers(50, 200, 8)]
    outs = engine.generate_batch(prompts, sp)  # compile + warmup
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, sp)
        rates.append(sum(len(o["token_ids"]) for o in outs) / (time.perf_counter() - t0))
    return float(np.median(rates))


def _ragged_workload(cfg):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128_000, int(n)).tolist() for n in rng.integers(50, 700, N_RAGGED)]
    # ~1% of the vocab as stop tokens: greedy argmax over random weights halts
    # each row at an approximately geometric length (mean ~100)
    stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, cfg.vocab_size // 100, replace=False))
    return prompts, stops


def measure_hbm_bw() -> float:
    """Achieved device-memory bandwidth (bytes/s) of a saturating jitted triad
    over a 1 GiB bf16 buffer (1 read + 1 write stream), repeated 16 times inside
    one jit: the MEASURED bound the decode roofline divides by. Median of 3."""
    n = 512 * 1024 * 1024  # 1 GiB of bf16
    reps = 16
    x = jnp.zeros((n,), jnp.bfloat16)
    f = jax.jit(
        lambda a: jax.lax.scan(lambda c, _: (c + jnp.bfloat16(1.0), None), a, None, length=reps)[0]
    )
    y = jax.block_until_ready(f(x))  # compile + warm
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        y = jax.block_until_ready(f(y))
        rates.append(reps * 2 * n * 2 / (time.perf_counter() - t0))
    return float(np.median(rates))


def decode_roofline(stats: dict, tok_s: float, hbm_bw: float, chunk: int, slots: int) -> dict:
    """Measured roofline: the device-memory bytes the run's
    dispatches must move (weights per scan step + per-slot page-rounded KV +
    prefill weight streams) over the MEASURED triad bandwidth. ratio_to_bound
    is the attributable gap: 1.0 = bandwidth-bound speed of light."""
    bytes_total = stats.get("weight_bytes", 0.0) + stats.get("kv_bytes", 0.0)
    if not bytes_total or not stats.get("wall_s"):
        return {}
    bound_s = bytes_total / hbm_bw
    bound_tok_s = stats["tokens_out"] / bound_s
    # occupancy: decode-slot utilization — tokens actually emitted over the
    # slot-steps the dispatched chunks paid for. The weights stream is per
    # STEP, so the roofline (which counts the bytes actually moved) already
    # prices the ragged drain; occupancy says how much of the remaining gap
    # is scheduling (idle slots) rather than kernel inefficiency.
    occ = None
    if stats.get("chunk_dispatches"):
        denom = stats["chunk_dispatches"] * chunk * slots
        occ = round(stats["tokens_out"] / denom, 3) if denom else None
    return {
        "weight_gb": round(stats["weight_bytes"] / 1e9, 2),
        "kv_gb": round(stats["kv_bytes"] / 1e9, 2),
        "bound_tok_s": round(bound_tok_s, 1),
        "ratio_to_bound": round(bound_tok_s / tok_s, 2),
        "occupancy": occ,
        "host_block_s": round(
            stats.get("dispatch_block_s", 0.0)
            + stats.get("prefill_block_s", 0.0)
            + stats.get("harvest_block_s", 0.0),
            3,
        ),
        "wall_s": round(stats["wall_s"], 3),
    }


def bench_ragged(cfg, params, kind, n_runs: int = 1, quantize=None):
    from ssi_jax.generate.engine import DecodeEngine, SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine

    prompts, stops = _ragged_workload(cfg)
    sp = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)

    stats = {}
    if kind == "paged":
        engine = PagedDecodeEngine(
            params, cfg, pad_id=133_006, n_slots=SLOTS,
            max_context=max(len(p) for p in prompts) + MAX_TOKENS,
            quantize=quantize,
        )
        run = lambda: engine.generate_batch(prompts, sp)
    else:
        engine = DecodeEngine(params, cfg, pad_id=133_006)

        def run():
            outs = []
            for s in range(0, len(prompts), DENSE_BATCH):
                chunk = prompts[s : s + DENSE_BATCH]
                while len(chunk) < DENSE_BATCH:  # final partial batch pads with a dummy
                    chunk = chunk + [prompts[0]]
                outs.extend(engine.generate_batch(chunk, sp)[: len(prompts) - s])
            return outs

    outs = run()  # compile + warmup
    runs = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        outs = run()
        dt = time.perf_counter() - t0
        total = sum(len(o["token_ids"]) for o in outs)
        runs.append((total / dt, dict(engine.last_stats) if kind == "paged" else {}))
    runs.sort(key=lambda r: r[0])
    median, stats = runs[len(runs) // 2]
    # live dispatch geometry for the roofline (not the module constants, so the
    # occupancy denominator tracks the engine's actual chunk/slot choice)
    if kind == "paged":
        stats["dispatch_chunk"] = engine.chunk
        stats["dispatch_slots"] = engine.n_slots
    return median, total, [o["token_ids"] for o in outs], stats


def main() -> None:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    cfg, params = _model()
    hbm_bw = measure_hbm_bw()
    dense_b8 = bench_dense_b8(cfg, params)
    dense_rg, dense_total, dense_tok, _ = bench_ragged(cfg, params, "dense")
    paged_rg, paged_total, paged_tok, pstats = bench_ragged(cfg, params, "paged", n_runs=3)
    int8_rg, _, int8_tok, istats = bench_ragged(cfg, params, "paged", n_runs=3, quantize="int8")
    # bf16 argmax ties flip between programs on random weights; report the match
    # fraction (fp32-CPU bitwise parity is asserted in tests/test_paged_decode.py)
    match_frac = sum(a == b for a, b in zip(dense_tok, paged_tok)) / len(dense_tok)

    # int8 quality gate: greedy agreement vs bf16 on the
    # same engine/workload. NB on RANDOM weights logit margins are ~0, so any
    # quantization noise flips argmax — this is an adversarial LOWER bound and
    # a drift detector, not the acceptance number. The acceptance measurement
    # for the opt-in mode is on a real checkpoint: run scripts/generate.py
    # twice (quantize_weights=null / int8) and score both with
    # scripts/wer_parity.py --skip-generate; acceptance = WER delta <= 0.1
    # (same bar as BASELINE's reference-parity target).
    exact = sum(a == b for a, b in zip(paged_tok, int8_tok)) / len(paged_tok)
    prefix_fracs = []
    for a, b in zip(paged_tok, int8_tok):
        n = min(len(a), len(b))
        shared = next((i for i in range(n) if a[i] != b[i]), n)
        prefix_fracs.append(shared / max(n, 1))
    int8_prefix_agreement = sum(prefix_fracs) / len(prefix_fracs)

    roofline = lambda stats, tok_s: decode_roofline(
        stats, tok_s, hbm_bw, stats.get("dispatch_chunk", CHUNK), stats.get("dispatch_slots", SLOTS)
    )

    print(
        json.dumps(
            {
                "metric": "decode_tokens_per_second_1b_greedy",
                "value": round(paged_rg, 1),
                "unit": "tokens/s",
                "detail": {
                    "dense_b8_uniform": round(dense_b8, 1),
                    "dense_b32_ragged": round(dense_rg, 1),
                    "paged_b48_ragged": round(paged_rg, 1),
                    "paged_vs_dense_ragged": round(paged_rg / dense_rg, 2),
                    "paged_int8_b48_ragged": round(int8_rg, 1),
                    "ragged_tokens": paged_total,
                    "greedy_match_fraction_vs_dense": round(match_frac, 3),
                    "int8_exact_sequence_agreement": round(exact, 3),
                    "int8_greedy_prefix_agreement": round(int8_prefix_agreement, 3),
                    "hbm_bw_gbs": round(hbm_bw / 1e9, 1),
                    "roofline_bf16": roofline(pstats, paged_rg),
                    "roofline_int8": roofline(istats, int8_rg),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
