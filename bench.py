#!/usr/bin/env python
"""Headline benchmark: Llama-3.2-1B CPT training throughput on one NVIDIA GPU.

Measures the reference's own headline metric — ``tokens_per_second_per_gpu``
(non-ignored label tokens per optimizer-step wall second; ref: ssi/trainer.py:467) —
for the extended-vocab 1B model at the CPT optimizer-step shape (64 sequences x
seq 768 per step, bf16, n_dsus=5000 -> vocab 133258).

Micro-batching is an implementation knob with identical optimizer semantics (the
window consumes the same 64 consecutive samples and normalizes the loss by the
window token count, ref: ssi/trainer.py:391-404): the configuration here is
micro-batch 4 x accum 16 with selective rematerialization ("save_qkv_mlp" keeps
the QKV and MLP matmul outputs resident) and single-chunk fused CE. These shapes
were chosen on another accelerator and have not been re-swept on the H100.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device", "extra"}
where extra carries the SFT-shape and packed-CPT throughputs plus the paged
continuous-batching decode numbers (bf16 + int8) at the serving shape. Every
time is a host clock around work that ends in ``block_until_ready``; steps
report the median and the spread (min, max).

On the two packing numbers: ``packed_cpt_tokens_per_sec`` is a kernel-overhead
A/B — both variants get identical FULL-length token grids, so packed cannot be
faster by construction (it pays the segment-mask pass and has no padding to
recover). ``packing_effective`` is packing's actual purpose measured: effective
non-pad tokens/s at the reference's real CPT length distribution (mean 39.43
tokens/row vs seq 768), where padded rows waste most of every step.

Baseline: the reference publishes no number (BASELINE.md). We use an engineering
estimate of 1x A6000 torch-eager throughput for this exact workload:
~6,000 tokens/s (A6000 ~155 bf16 TFLOP/s at ~30% eager-mode MFU over the ~7.4
GFLOPs/token fwd+bwd of a 1.24B decoder + 133k-vocab CE). vs_baseline is
reported against 2x that, 12,000 tokens/s.
"""

import json
import os
import time

import jax

import ssi_jax  # noqa: F401  (the package's one compile-cache location)

import jax.numpy as jnp
import numpy as np

BASELINE_TOKENS_PER_SEC = 12_000.0  # 2x estimated A6000 eager throughput (see docstring)

WARMUP = 3
STEPS = 10

# (micro_batch, accum, seq, remat, ce_chunk) per workload; optimizer-window token
# counts match the reference defaults (CPT: bs16 x accum4 x 768; SFT: bs2 x accum4
# x 2048 — conf/training.yaml grad_accum 4, conf/data/_*_base.yaml batch sizes).
CPT_SHAPE = (4, 16, 768, "save_qkv_mlp", 3072)
SFT_SHAPE = (2, 4, 2048, "save_qkv_mlp", 2048)


def _measure(shape, packed: bool = False, steps: int = STEPS, detail: bool = False, timed_ctx=None,
             batch_data=None):
    """Measure the fused optimizer-window step. ``timed_ctx``, when given, is a
    context manager entered around the TIMED loop only (init, compile, and
    warmup stay outside) — tools/profile_train.py passes jax.profiler.trace so
    the captured xplane holds steady-state steps and nothing else.

    ``batch_data``: optional ``(tokens, labels, segment_ids|None, positions|None)``
    numpy arrays replacing the default dense random grid — the effective-packing
    comparison feeds realistic padded/packed windows through the SAME compiled
    step (shapes are identical, so no recompile)."""
    from ssi_jax.models.configs import configllama3_2_1b
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.parallel import batch_sharding, make_mesh, param_shardings, replicated, shard_params
    from ssi_jax.train.lr_schedule import cosine_schedule_with_warmup
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    # optional 6th element: attention impl override ("xla" | "cudnn")
    attn_impl = shape[5] if len(shape) > 5 else "auto"
    batch, accum, seq, remat, chunk = shape[:5]
    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True

    mesh = make_mesh(tp=1)
    n_chips = mesh.devices.size

    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    params = shard_params(mesh, params)
    # torch-parity dtypes: the reference's bf16 AdamW keeps exp_avg AND exp_avg_sq
    # in bf16 (torch optimizer state follows param dtype)
    opt_cfg = AdamWConfig(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16)
    opt_state = jax.jit(
        lambda p: init_opt_state(p, opt_cfg),
        out_shardings={
            "mu": param_shardings(mesh, params),
            "nu": param_shardings(mesh, params),
            "count": replicated(mesh),
        },
    )(params)
    state = {"params": params, "opt_state": opt_state, "step": jnp.zeros((), jnp.int32)}

    schedule = cosine_schedule_with_warmup(2e-4, 1000, 100_000)
    step = make_train_step(
        cfg, opt_cfg, schedule, clip_grad_norm=None, chunk_size=chunk,
        remat=remat, attn_impl=attn_impl,
        grad_accum_dtype=jnp.bfloat16,  # torch-parity: reference accumulates in bf16 .grad buffers
    )

    bsh = batch_sharding(mesh)
    if batch_data is not None:
        tokens, labels, seg, pos = batch_data
        args = [jax.device_put(np.asarray(tokens, np.int32), bsh), jax.device_put(np.asarray(labels, np.int32), bsh)]
        if seg is not None:
            args += [jax.device_put(np.asarray(seg, np.int32), bsh), jax.device_put(np.asarray(pos, np.int32), bsh)]
    else:
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (accum, batch, seq)).astype(np.int32)
        labels = tokens.copy()
        args = [jax.device_put(tokens, bsh), jax.device_put(labels, bsh)]
        if packed:
            # two packed segments per row (the packed-CPT path: segment-masked
            # attention + boundary-stopped label shift)
            seg = np.ones((accum, batch, seq), np.int32)
            seg[..., seq // 2:] = 2
            pos = np.concatenate(
                [np.arange(seq // 2, dtype=np.int32), np.arange(seq - seq // 2, dtype=np.int32)]
            )
            pos = np.broadcast_to(pos, (accum, batch, seq)).copy()
            args += [jax.device_put(seg, bsh), jax.device_put(pos, bsh)]

    for _ in range(WARMUP):
        state, metrics = step(state, *args)
    jax.block_until_ready(metrics)
    tokens_per_step = int(metrics["num_tokens"])  # ground truth from the step itself

    from contextlib import nullcontext

    times = []
    with timed_ctx if timed_ctx is not None else nullcontext():
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, *args)
            jax.block_until_ready(metrics)
            times.append(time.perf_counter() - t0)
    step_time = float(np.median(times))
    tok_s = tokens_per_step / step_time / n_chips
    if detail:
        return tok_s, step_time, tokens_per_step, (min(times), max(times))
    return tok_s


def _measure_packing_effective(shape, steps: int = 6) -> dict:
    """Packing's REAL win: effective (non-pad) tokens/s at the reference's CPT
    length distribution (interleave stats mean_seq_len_tokens 39.43, ref
    conf/data/_cpt_base.yaml:12) vs padding each short row to seq.

    The headline `packed_cpt_tokens_per_sec` A/B feeds both variants identical
    FULL-length token grids, so it can only ever show packing's segment-mask
    overhead (~0.6%), never its purpose; this measurement feeds each variant
    what it would actually train on. Both windows reuse the already-compiled
    dense/packed step programs (same shapes)."""
    batch, accum, seq, _, _ = shape[:5]
    rng = np.random.default_rng(7)
    vocab = 128_000

    def draw_len():
        return int(np.clip(rng.geometric(1.0 / 39.43), 4, seq))

    # padded: one short sample per row, rest is pad (labels -100)
    tokens_pad = np.zeros((accum, batch, seq), np.int32)
    labels_pad = np.full((accum, batch, seq), -100, np.int32)
    real_pad = 0
    for a in range(accum):
        for b in range(batch):
            n = draw_len()
            row = rng.integers(0, vocab, n)
            tokens_pad[a, b, :n] = row
            labels_pad[a, b, :n] = row
            real_pad += n

    # packed: fill every row with consecutive samples (segment ids + restarting
    # positions), pad only the final tail of each row
    tokens_pk = np.zeros((accum, batch, seq), np.int32)
    labels_pk = np.full((accum, batch, seq), -100, np.int32)
    segs_pk = np.zeros((accum, batch, seq), np.int32)
    pos_pk = np.zeros((accum, batch, seq), np.int32)
    real_pk = 0
    for a in range(accum):
        for b in range(batch):
            off, sid = 0, 1
            while True:
                n = draw_len()
                if off + n > seq:
                    break
                row = rng.integers(0, vocab, n)
                tokens_pk[a, b, off : off + n] = row
                labels_pk[a, b, off : off + n] = row
                segs_pk[a, b, off : off + n] = sid
                pos_pk[a, b, off : off + n] = np.arange(n)
                off += n
                sid += 1
                real_pk += n

    pad_tok_s, _pad_step_s, _pad_tokens, _ = _measure(
        shape, steps=steps, detail=True, batch_data=(tokens_pad, labels_pad, None, None)
    )
    pk_tok_s, _pk_step_s, _pk_tokens, _ = _measure(
        shape, steps=steps, detail=True, batch_data=(tokens_pk, labels_pk, segs_pk, pos_pk)
    )
    return {
        "padded_real_tok_s": round(pad_tok_s, 1),
        "packed_real_tok_s": round(pk_tok_s, 1),
        "packing_speedup": round(pk_tok_s / pad_tok_s, 2),
        "padded_fill_fraction": round(real_pad / (accum * batch * seq), 4),
        "packed_fill_fraction": round(real_pk / (accum * batch * seq), 4),
        "note": "effective non-pad tokens/s at the reference CPT length distribution (mean 39.43)",
    }


def model_flops_per_token(cfg, seq: int) -> float:
    """Mandatory fwd+bwd matmul FLOPs per token (PaLM MFU convention: remat
    recompute counts as overhead, not useful work — so MFU is honest about the
    cost of rematerialization)."""
    d, f, hd = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    hq, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size
    per_layer = (
        2 * d * (hq * hd)          # wq
        + 2 * 2 * d * (hkv * hd)   # wk, wv
        + 2 * (hq * hd) * d        # wo
        + 3 * 2 * d * f            # w_gate, w_up, w_down
        + 2 * 2 * hq * hd * (seq / 2)  # causal attention: scores + values over ~seq/2 keys
    )
    fwd = nl * per_layer + 2 * d * v  # + unembed/CE projection
    return 3.0 * fwd  # fwd + 2x-fwd backward


# Published dense peaks per device_kind (NVIDIA H100 data sheet, SXM part, no
# sparsity; they assume the full 700 W power limit). A device missing here is an
# error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12,
                              "source": "NVIDIA H100 data sheet (SXM, dense)"},
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peak bf16 FLOP/s and memory bandwidth for ``device_kind`` (default: the
    first device's); raises for a device the table does not know."""
    kind = device_kind if device_kind is not None else jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"No published peak for device_kind {kind!r}; add it to bench.PEAKS with its source")
    return PEAKS[kind]


def _measure_decomposition(shape, steps: int = 6) -> dict:
    """Micro-program attribution at the CPT shape: time the loss-only forward
    and value_and_grad as STANDALONE jitted programs at the micro-batch shape.

    These are not a partition of the fused step's wall time — the fused
    accumulation scan out-fuses the standalone programs (XLA overlaps the
    optimizer update and accumulation traffic with the next micro-batch's
    compute), so micro timings scaled by accum can legitimately exceed
    step_time. They attribute fwd-vs-bwd regressions; ``fused_window_speedup``
    in the bench output records how much the fused window wins over the naive
    micro-program composition."""
    from ssi_jax.models.configs import configllama3_2_1b
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.train.step import make_loss_fn

    batch, accum, seq, remat, chunk = shape
    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    loss_fn = make_loss_fn(cfg, remat=remat, chunk_size=chunk)

    # micro-batch shape (the unit the accum scan executes); the window cost is
    # accum x these — a whole-window single grad would blow the activation HBM
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, seq)), jnp.int32)

    def micro_loss(p, tk):
        s, n = loss_fn(p, tk, tk)
        return s / jnp.maximum(n, 1)

    fwd_fn = jax.jit(micro_loss)
    grad_fn = jax.jit(jax.grad(micro_loss))

    def timed(fn):
        # `accum` dispatches per timed window, like the fused accumulation scan
        out = fn(params, tokens)
        jax.block_until_ready(out)
        ts = []
        for _ in range(steps):
            t0 = time.perf_counter()
            for _ in range(accum):
                out = fn(params, tokens)
            jax.block_until_ready(out)
            ts.append((time.perf_counter() - t0) / accum)
        return float(np.median(ts))

    t_fwd = timed(fwd_fn)
    t_grad = timed(grad_fn)
    return {"micro_fwd_s": t_fwd, "micro_fwd_bwd_s": t_grad, "accum": accum}


def _measure_paged_decode(quantize=None, hbm_bw: float | None = None, attn_impl: str = "auto", runs: int = 3):
    """Paged continuous-batching decode at the serving shape. Ragged workload
    identical to bench_decode.py's: 96 prompts, ~geometric generation lengths via
    a 1%-vocab stop set.

    Returns ``(median tokens_per_s, (min, max), roofline_dict)``: when ``hbm_bw``
    (measured triad bandwidth, bytes/s) is given, the median run's engine stats
    are priced against it (``ratio_to_bound``) alongside the raw throughput."""
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.configs import configllama3_2_1b
    from ssi_jax.models.llama3 import init_params

    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    params = init_params(cfg, jax.random.key(0), dtype=jnp.bfloat16)

    max_tokens = 256
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128_000, int(n)).tolist() for n in rng.integers(50, 700, 96)]
    stops = tuple(int(t) for t in rng.choice(cfg.vocab_size, cfg.vocab_size // 100, replace=False))
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=stops)
    engine = PagedDecodeEngine(
        params, cfg, pad_id=133_006, n_slots=96,
        max_context=max(len(p) for p in prompts) + max_tokens,
        quantize=quantize, attn_impl=attn_impl,
    )
    engine.generate_batch(prompts, sp)  # compile + warmup
    runs_out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, sp)
        dt = time.perf_counter() - t0
        runs_out.append((sum(len(o["token_ids"]) for o in outs) / dt, dict(engine.last_stats)))
    runs_out.sort(key=lambda r: r[0])
    tok_s, stats = runs_out[len(runs_out) // 2]
    roofline = {}
    if hbm_bw:
        from bench_decode import decode_roofline

        roofline = decode_roofline(stats, tok_s, hbm_bw, engine.chunk, engine.n_slots)
    return tok_s, (runs_out[0][0], runs_out[-1][0]), roofline


def main() -> None:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    cpt, cpt_step_s, _cpt_tokens, cpt_spread = _measure(CPT_SHAPE, detail=True)
    sft = _measure(SFT_SHAPE, steps=6)
    packed = _measure(CPT_SHAPE, packed=True, steps=6)
    packing_eff = _measure_packing_effective(CPT_SHAPE)
    decomp = _measure_decomposition(CPT_SHAPE)
    from bench_decode import measure_hbm_bw

    hbm_bw = measure_hbm_bw()
    paged, paged_spread, paged_roof = _measure_paged_decode(hbm_bw=hbm_bw)
    paged_int8, paged_int8_spread, paged_int8_roof = _measure_paged_decode(quantize="int8", hbm_bw=hbm_bw)

    # MFU: mandatory model FLOPs (remat recompute = overhead) / chip peak
    from ssi_jax.models.configs import configllama3_2_1b

    cfg = configllama3_2_1b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    flops_tok = model_flops_per_token(cfg, CPT_SHAPE[2])
    peak = peaks["bf16_flops"]
    mfu = cpt * flops_tok / peak

    # micro-program attribution (NOT a partition of step_time — see
    # _measure_decomposition): standalone fwd / fwd+bwd programs at the
    # micro-batch shape, plus how much the fused accumulation window beats
    # their naive composition
    micro_window_fwd_s = decomp["micro_fwd_s"] * decomp["accum"]
    micro_window_fwd_bwd_s = decomp["micro_fwd_bwd_s"] * decomp["accum"]
    fused_speedup = micro_window_fwd_bwd_s / cpt_step_s if cpt_step_s else None
    print(
        json.dumps(
            {
                "metric": "train_tokens_per_second_per_chip_1b_cpt",
                "value": round(cpt, 1),
                "unit": "tokens/s/chip",
                "vs_baseline": round(cpt / BASELINE_TOKENS_PER_SEC, 3),
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
                "extra": {
                    "mfu": round(mfu, 4),
                    "model_flops_per_token": round(flops_tok),
                    "peak_flops_per_chip": peak,
                    "peak_source": peaks["source"],
                    "step_time_s": round(cpt_step_s, 4),
                    "step_time_min_max_s": [round(t, 4) for t in cpt_spread],
                    "micro_attribution_s": {
                        "micro_fwd": round(decomp["micro_fwd_s"], 4),
                        "micro_fwd_bwd": round(decomp["micro_fwd_bwd_s"], 4),
                        "micro_window_fwd": round(micro_window_fwd_s, 4),
                        "micro_window_fwd_bwd": round(micro_window_fwd_bwd_s, 4),
                        "fused_window_speedup": round(fused_speedup, 3) if fused_speedup else None,
                        "note": "standalone micro programs, not a partition of step_time_s",
                    },
                    "sft_tokens_per_sec_bs2x2048": round(sft, 1),
                    "packed_cpt_tokens_per_sec": round(packed, 1),
                    "packing_effective": packing_eff,
                    "paged_decode_tok_s": round(paged, 1),
                    "paged_decode_tok_s_min_max": [round(x, 1) for x in paged_spread],
                    "paged_decode_int8_tok_s": round(paged_int8, 1),
                    "paged_decode_int8_tok_s_min_max": [round(x, 1) for x in paged_int8_spread],
                    "paged_decode_int8_ratio": round(paged_int8 / paged, 3),
                    "hbm_bw_gbs": round(hbm_bw / 1e9, 1),
                    "paged_decode_roofline_bf16": paged_roof,
                    "paged_decode_roofline_int8": paged_int8_roof,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
