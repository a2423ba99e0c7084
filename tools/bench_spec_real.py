#!/usr/bin/env python
"""Speculative decoding on a REAL checkpoint over REAL (repetitive ASR) text.

On random weights the n-gram drafter can't hit (acceptance ~1.15
tokens/verify, an algorithmic count) — this tool
measures acceptance and net throughput on the workload spec decode exists
for: a trained DSU-ASR checkpoint transcribing Zipf-weighted English, i.e.
highly repetitive output text (ref workload: scripts/generate.py decoding
MLS transcripts).

Reuses the WER drive's artifacts verbatim (same checkpoint, same test rows,
same tokenizer) and the resolved generation_config.yaml snapshot written by
scripts/generate.py, so the engine setup is identical to serving — only
``speculate_k`` varies.

Run on the GPU host AFTER tools/wer_drive.py:

    SSI_JAX_HOME=.wer_drive python tools/bench_spec_real.py

Writes <workdir>/spec_decode.json with per-k tok/s, acceptance,
greedy agreement vs k=0, and the break-even recommendation.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path
import sys
import time

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax

import ssi_jax  # noqa: E402,F401  (the package's one compile-cache location)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

logging.basicConfig(level=logging.INFO, format="[%(asctime)s][spec_real] %(message)s")
LOGGER = logging.getLogger("spec_real")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", type=Path, default=REPO / ".wer_drive")
    ap.add_argument("--gen-dir", type=Path, default=None,
                    help="generation output dir with generation_config.yaml (default: <workdir>/gen_bf16/json/test)")
    ap.add_argument("--ks", default="0,2,3,4")
    ap.add_argument("--out", type=Path, default=REPO / ".wer_drive" / "spec_decode.json")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    gen_dir = args.gen_dir or (args.workdir / "gen_bf16" / "json" / "test")
    os.environ.setdefault("SSI_JAX_HOME", str(args.workdir))

    from ssi_jax.checkpoint import Checkpointer
    from ssi_jax.config import Config, load_yaml, to_container
    from ssi_jax.data.sft import SFTDataset
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.configs import get_model_config
    from ssi_jax.tokenizer import setup_llama3_tokenizer

    cfg = Config(load_yaml(gen_dir / "generation_config.yaml"))

    tokenizer, _ = setup_llama3_tokenizer(**{k: v for k, v in cfg.tokenizer.items()})
    stop_ids = list(tokenizer.stop_tokens)

    model_cfg = get_model_config(cfg.get("model_config", "llama3_2_1b")).copy()
    model_cfg.update_from_speech_cfg(cfg.speech)
    ckpt = Checkpointer(
        checkpoint_dir=cfg.model,
        output_dir=args.workdir / "_spec_scratch",
        model_expectations=model_cfg.checkpoint_expectations,
    )
    import jax.numpy as jnp

    params = jax.device_put(ckpt.load_params(model_cfg, dtype=jnp.bfloat16))

    ds_kwargs = to_container(cfg.data[cfg.gen.split].dataset, resolve=True)
    dataset = SFTDataset(model_tokenizer=tokenizer, **ds_kwargs)
    prompts = [dataset[i]["tokens"] for i in range(len(dataset))]
    sp = SamplingParams.from_cfg(cfg.sampling_params, stop_ids)
    n_slots = int(cfg.get("batch_size", 48))
    max_context = max(len(p) for p in prompts) + sp.max_tokens

    results: dict[str, dict] = {}
    base_tok = None
    for k in [int(x) for x in args.ks.split(",")]:
        engine = PagedDecodeEngine(
            params, model_cfg, pad_id=tokenizer.pad_id, n_slots=n_slots,
            max_context=max_context, speculate_k=k,
            prefix_caching=bool(cfg.get("prefix_caching", True)),
        )
        engine.generate_batch(prompts, sp)  # compile + warmup
        best, outs = 0.0, None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            outs = engine.generate_batch(prompts, sp)
            dt = time.perf_counter() - t0
            total = sum(len(o["token_ids"]) for o in outs)
            best = max(best, total / dt)
        toks = [o["token_ids"] for o in outs]
        if k == 0:
            base_tok = toks
        st = engine.last_stats or {}
        results[f"k{k}"] = {
            "tok_s": round(best, 1),
            "tokens_out": total,
            "tokens_per_verify": round(st["tokens_per_verify"], 3) if st.get("tokens_per_verify") else None,
            "agreement_vs_k0": None if base_tok is None
            else round(sum(a == b for a, b in zip(base_tok, toks)) / len(toks), 4),
        }
        LOGGER.info(f"k={k}: {results[f'k{k}']}")
        del engine

    base = results["k0"]["tok_s"]
    wins = {k: r["tok_s"] for k, r in results.items() if k != "k0" and r["tok_s"] > base}
    best_k = max(wins, key=wins.get) if wins else None
    summary = {
        "workload": "trained DSU-ASR checkpoint (wer_drive step_800), 256 real test prompts, greedy",
        "n_slots": n_slots,
        "results": results,
        "baseline_tok_s": base,
        "best_k": best_k,
        "best_speedup": round(wins[best_k] / base, 3) if best_k else None,
        "recommendation": (
            f"enable speculate_k={best_k.lstrip('k')} for repetitive ASR serving"
            if best_k else "keep speculate_k=0 (n-gram draft below break-even on this workload)"
        ),
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=2) + "\n")
    LOGGER.info(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
