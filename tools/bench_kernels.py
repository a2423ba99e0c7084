#!/usr/bin/env python
"""Time each hand-chosen attention path on the card against the plain XLA version.

At the 1B widths (32 query / 8 KV heads, head dim 64, bf16, vocab 133,258):

- training attention, ``xla`` (einsum) vs ``cudnn``, forward + backward inside the
  jitted train step: CPT micro-batch 4 x 768, SFT 2 x 2048, and packed CPT rows
  (segment ids) at 4 x 768;
- prompt prefill (``prefill_prompts``, group 8 x bucket 768), ``xla`` vs ``cudnn``;
- paged decode end to end (``PagedDecodeEngine.generate_batch``) at the serving
  shape (96 ragged prompts of 50-700 tokens, 256 new tokens each, 96 slots),
  ``gather`` vs the ``triton`` kernel.

Both variants are built first and then run in alternation (A B A B ...) in one
process, so they share the card, its clocks and its neighbours. Every time is a
host clock around work that ends in ``block_until_ready``; the median and the
spread (min, max) are reported. Each result line names the card and its power
limit. Needs an NVIDIA GPU.

Usage: python tools/bench_kernels.py [--out chiprun_out/bench_kernels.jsonl] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import subprocess
import sys
import time

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def model_cfg():
    from ssi_jax.models.configs import configllama3_2_1b

    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    return cfg


def alternate(fns: dict, reps: int) -> dict:
    """Run each zero-arg ``fn`` (which blocks) ``reps`` times, interleaved."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
    return {k: {"median_s": float(np.median(v)), "min_s": float(min(v)), "max_s": float(max(v)), "n": len(v)}
            for k, v in times.items()}


def bench_train(label: str, batch: int, seq: int, packed: bool, reps: int) -> dict:
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.train.lr_schedule import constant_schedule
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    cfg = model_cfg()
    accum = 2
    opt_cfg = AdamWConfig(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (accum, batch, seq)), jnp.int32)
    extra = ()
    if packed:
        # ragged documents (mean ~39 tokens, the reference CPT length) packed per row
        seg = np.zeros((accum, batch, seq), np.int32)
        pos = np.zeros((accum, batch, seq), np.int32)
        for a in range(accum):
            for b in range(batch):
                off, sid = 0, 1
                while off < seq:
                    n = min(int(rng.geometric(1 / 39.43)) + 3, seq - off)
                    seg[a, b, off:off + n] = sid
                    pos[a, b, off:off + n] = np.arange(n)
                    off, sid = off + n, sid + 1
        extra = (jnp.asarray(seg), jnp.asarray(pos))
    states, steps = {}, {}
    for impl in ("xla", "cudnn"):
        params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
        states[impl] = {"params": params, "opt_state": jax.jit(lambda p: init_opt_state(p, opt_cfg))(params),
                        "step": jnp.zeros((), jnp.int32)}
        steps[impl] = make_train_step(cfg, opt_cfg, constant_schedule(1e-4), remat="save_qkv_mlp", chunk_size=3072,
                                      attn_impl=impl, grad_accum_dtype=jnp.bfloat16)
        t0 = time.perf_counter()
        for _ in range(2):  # compile + warm
            states[impl], m = steps[impl](states[impl], tokens, tokens, *extra)
        jax.block_until_ready(m)
        print(f"[{CARD}] {label} {impl}: compile+2 warm steps {time.perf_counter() - t0:.1f} s", flush=True)

    def run(impl):
        def fn():
            states[impl], m = steps[impl](states[impl], tokens, tokens, *extra)
            jax.block_until_ready(m["loss_sum"])
        return fn

    res = alternate({impl: run(impl) for impl in steps}, reps)
    ntok = accum * batch * seq
    for r in res.values():
        r["tokens_per_s"] = ntok / r["median_s"]
    return {"bench": "train_step", "shape": label, "window": f"{accum}x{batch}x{seq}", "packed": packed, **res}


def bench_prefill(reps: int, group: int = 8, bucket: int = 768, ps: int = 128) -> dict:
    from ssi_jax.generate.paged import init_pools, prefill_prompts
    from ssi_jax.models.llama3 import init_params

    cfg = model_cfg()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    n_pages = group * bucket // ps
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, 128_000, (group, bucket)), jnp.int32)
    page_ids = jnp.arange(n_pages, dtype=jnp.int32).reshape(group, bucket // ps)
    fns, pools = {}, {}
    for impl in ("xla", "cudnn"):
        pools[impl] = init_pools(cfg, n_pages, ps, dtype=jnp.bfloat16)
        f = jax.jit(
            lambda p, pl, t, ids, impl=impl: prefill_prompts(p, t, cfg, pl, ids, n_pages=n_pages, prefill_impl=impl),
            donate_argnums=(1,),
        )
        pools[impl] = f(params, pools[impl], tokens, page_ids)
        jax.block_until_ready(pools[impl])

        def fn(impl=impl, f=f):
            pools[impl] = f(params, pools[impl], tokens, page_ids)
            jax.block_until_ready(pools[impl])
        fns[impl] = fn
    return {"bench": "prefill", "shape": f"group {group} x bucket {bucket}", **alternate(fns, reps)}


def bench_decode(reps: int) -> dict:
    """Both variants do identical work: no stop tokens, so every request emits
    exactly ``max_tokens`` at its ragged prompt length, and each timed run's
    token count is checked."""
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.llama3 import init_params

    cfg = model_cfg()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    max_tokens = 256
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128_000, int(n)).tolist() for n in rng.integers(50, 700, 96)]
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=())
    max_context = max(len(p) for p in prompts) + max_tokens
    n_tok = len(prompts) * max_tokens
    engines, outs = {}, {}
    for impl in ("gather", "triton"):
        engines[impl] = PagedDecodeEngine(params, cfg, pad_id=133_006, n_slots=96, max_context=max_context,
                                          attn_impl=impl)
        t0 = time.perf_counter()
        outs[impl] = [o["token_ids"] for o in engines[impl].generate_batch(prompts, sp)]  # compile + warm
        print(f"[{CARD}] decode {impl}: compile+warm run {time.perf_counter() - t0:.1f} s", flush=True)
    agree = float(np.mean([a == b for a, b in zip(outs["gather"], outs["triton"])]))

    def run(impl):
        def fn():
            n = sum(len(o["token_ids"]) for o in engines[impl].generate_batch(prompts, sp))  # harvest syncs
            if n != n_tok:
                raise AssertionError(f"decode {impl}: {n} tokens, expected {n_tok}")
        return fn

    res = alternate({k: run(k) for k in engines}, reps)
    for r in res.values():
        r["tokens_per_s"] = n_tok / r["median_s"]
        r["generated_tokens"] = n_tok
    return {"bench": "paged_decode",
            "shape": f"96 slots, 96 prompts 50-700, {max_tokens} new each (no stop), max_context {max_context}",
            "greedy_sequences_identical": agree, **res}


CARD = "unknown card"


def main() -> None:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "bench_kernels.jsonl")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU; JAX's first device is {jax.devices()[0].platform!r}")
    CARD = card()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    benches = [
        lambda: bench_train("cpt", 4, 768, False, args.reps),
        lambda: bench_train("sft", 2, 2048, False, args.reps),
        lambda: bench_train("cpt_packed", 4, 768, True, args.reps),
        lambda: bench_prefill(args.reps),
        lambda: bench_decode(max(3, args.reps // 2)),
    ]
    with open(args.out, "a") as f:
        for b in benches:
            r = {"card": CARD, "device_kind": jax.devices()[0].device_kind, **b()}
            f.write(json.dumps(r) + "\n")
            print(f"[{CARD}] {json.dumps(r)}", flush=True)


if __name__ == "__main__":
    main()
