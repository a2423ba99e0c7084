#!/usr/bin/env python
"""Smoke run of the main path on one NVIDIA GPU, through the normal entry points.

At the full width of ``llama3_2_1b`` extended with 5,000 DSUs (vocab 133,258),
random weights made from a seed, in ONE process:

  1. environment: the card (``nvidia-smi``), JAX's devices and version,
     ``XLA_FLAGS`` and the compile-cache directory;
  2. the main path's imports;
  3. synthetic assets: a 128,000-entry base tokenizer, a random-init base
     checkpoint, a CPT corpus, then ``scripts/extend_llama3_2.py``;
  4. kernel parity at real widths: cuDNN attention (forward and dQ/dK/dV, plain
     and packed rows) and the Triton paged decode kernel against the float32
     einsum references under ``jax.default_matmul_precision("highest")``;
  5. forward-logits parity of the 1B model, bf16 against float32;
  6. CPT training through ``Trainer`` (micro-batch 4 x accum 16 x 768): finite,
     falling loss, a saved ``step_N/``, ``memory_analysis()`` of the train step;
  7. resume: 2 steps + save + resume + 2 steps against a 4-step run, bitwise,
     all three with ``deterministic_ops=true`` (the train step alone compiles
     with ``xla_gpu_deterministic_ops``; without it the embedding gradient's
     atomics make the card drift in the last bits);
  8. serving ``step_N/`` through ``ssi_jax.serve.build_server`` over HTTP
     (completion, chat, stream), and an int8 engine on a few prompts.

``--four-cards`` runs only the four-card path instead: a dp=2 x tp=2 FSDP train
step against the same step on one card (float32), tensor-parallel paged decode
against one card (float32), and a few ``llama3_1_8b`` FSDP train steps.

Every line names the card and its power limit. The last line is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed. With no
GPU (or outside a checkout of the repository) it exits non-zero and prints no
result.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path
import shutil
import subprocess
import sys
import threading
import time

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke"  # listed in .gitignore; rebuilt by every run

CARD = "no GPU"  # "<name>, <power limit>" from nvidia-smi, set by main()

# Parity tolerances, as max|x - ref| / max|ref| against the float32 reference.
# Inputs are rounded to bf16 once and fed to both sides, so the error is what
# the kernel adds: bf16 rounding of the probabilities and the output (2^-9
# relative each) with float32 accumulation -> a few 1e-3; 1e-2 leaves headroom.
# Gradients pass through one more bf16 product chain (dP, dS), hence 2e-2.
TOL_OUT = 1e-2
TOL_GRAD = 2e-2
# 1B forward, bf16 against float32: ~10 bf16 roundings per layer over 16 layers
# accumulate like a random walk, sqrt(160) * 2^-9 ~ 2.5e-2 -> 5e-2.
TOL_LOGITS = 5e-2
LR = 1e-4  # constant; a first Adam step moves each weight by ~lr: 1e-3 overshoots the 1B from random init


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What a run is sized by; ``TINY`` is the CPU-test stand-in for ``FULL``."""

    model_config: str = "llama3_2_1b"
    n_dsus: int = 5000
    dtype: str = "bf16"
    micro_batch: int = 4
    accum: int = 16
    seq_len: int = 768
    train_steps: int = 4
    lr: float = LR
    n_rows: int = 4096
    slots: int = 8
    max_context: int = 1024
    # kernel parity shapes: (batch, seq, q heads, kv heads, head dim) and
    # (slots, page size, max pages) — the 1B widths at the serving shape
    attn_shape: tuple = (4, 768, 32, 8, 64)
    paged_shape: tuple = (96, 128, 8)
    logits_tokens: tuple = (2, 256)


FULL = Sizes()
TINY = Sizes(
    model_config="tiny_test", n_dsus=16, dtype="fp32", micro_batch=2, accum=2, seq_len=128, lr=1e-3,
    n_rows=64, slots=2, max_context=128, attn_shape=(2, 64, 4, 2, 16), paged_shape=(4, 16, 4),
    logits_tokens=(2, 16),
)


# ----------------------------------------------------------------------------- phases


def phase_environment() -> dict:
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
    }
    from ssi_jax import compile_cache_dir

    info["compile_cache"] = compile_cache_dir()
    log(f"environment: {json.dumps(info)} devices={jax.devices()}")
    return info


def phase_imports() -> None:
    import importlib

    for name in ("numpy", "tiktoken", "msgpack", "yaml", "datasets", "jinja2", "safetensors"):
        mod = importlib.import_module(name)
        log(f"import {name} {getattr(mod, '__version__', '')}")
    for name in ("ssi_jax.train", "ssi_jax.serve", "ssi_jax.generate.paged_engine",
                 "ssi_jax.generate.paged_triton", "ssi_jax.native"):
        importlib.import_module(name)
        log(f"import {name}")


def build_cpt_corpus(path: Path, n_dsus: int, n_rows: int, seed: int) -> None:
    """Word-aligned CPT rows (``tokenized`` words, alignment times, 50 Hz DSU
    frames): one DSU code per word, 0.3 s per word, 24 words per utterance."""
    import numpy as np

    from tools.wer_drive import WORDS

    rng = np.random.default_rng(seed)
    codes = rng.permutation(n_dsus)[: len(WORDS)] % n_dsus
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for _ in range(n_rows):
            idx = rng.choice(len(WORDS), 24, replace=True)
            t = np.arange(len(idx)) * 0.3
            speech = np.repeat(codes[idx % len(codes)], 15).tolist()  # 0.3 s at 50 Hz
            row = {"tokenized": [WORDS[i] for i in idx], "align_t_starts": t.tolist(),
                   "align_t_ends": (t + 0.3).tolist(), "speech_tokens": speech}
            f.write(json.dumps(row) + "\n")


def phase_assets(work: Path, sizes: Sizes) -> dict:
    import importlib.util
    from argparse import Namespace

    from ssi_jax.models.configs import get_model_config
    from tools.wer_drive import SEED, WORDS, build_base_checkpoint, build_base_tokenizer

    t0 = time.time()
    base = work / "base"
    ext = work / "extended"
    data = work / "data"
    cfg = get_model_config(sizes.model_config)
    build_base_tokenizer(base / "original" / "tokenizer.model", WORDS, vocab_size=cfg.base_vocab_size_txt)
    build_base_checkpoint(base, sizes.model_config, seed=SEED)
    build_cpt_corpus(data / "train.jsonl", sizes.n_dsus, sizes.n_rows, SEED)
    build_cpt_corpus(data / "dev.jsonl", sizes.n_dsus, 4 * sizes.micro_batch, SEED + 1)
    spec = importlib.util.spec_from_file_location("extend_llama3_2", REPO / "scripts" / "extend_llama3_2.py")
    extend = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(extend)
    extend.main(Namespace(
        n_new_dsus=sizes.n_dsus, input_dir=base, output_dir=ext, model_config=sizes.model_config,
        sigma_scaling=1.0, use_modality_tokens=True,
    ))
    log(f"assets: base + extended {sizes.model_config} (+{sizes.n_dsus} DSUs) and corpus in {time.time() - t0:.1f} s")
    return {"base": base, "ext": ext, "data": data}


def _rel_err(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(float(np.max(np.abs(ref))), 1e-30))


def _check(name: str, err: float, tol: float) -> None:
    log(f"parity {name}: max-abs error / max-abs reference = {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} exceeds {tol:.0e}")


def phase_kernel_parity(sizes: Sizes, interpret: bool = False) -> None:
    """Each kernel on the card against its float32 einsum reference.

    ``interpret=True`` (CPU tests only) runs the Triton kernel in the Pallas
    interpreter and the cuDNN wrapper through JAX's XLA implementation.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_jax.generate.paged import paged_attention
    from ssi_jax.generate.paged_triton import paged_attention_triton
    from ssi_jax.ops.attention import cudnn_attention, xla_attention

    impl = "xla" if interpret else "cudnn"
    b, s, hq, hkv, hd = sizes.attn_shape
    ks = jax.random.split(jax.random.key(0), 4)
    q = jax.random.normal(ks[0], (b, s, hq, hd), jnp.bfloat16)
    k = jax.random.normal(ks[1], (b, s, hkv, hd), jnp.bfloat16)
    v = jax.random.normal(ks[2], (b, s, hkv, hd), jnp.bfloat16)
    do = jax.random.normal(ks[3], (b, s, hq, hd), jnp.bfloat16)
    # packed rows: four documents of ragged length per row
    cuts = np.sort(np.random.default_rng(0).choice(np.arange(1, s), (b, 3), replace=False), axis=1)
    seg = jnp.asarray((np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1) + 1, jnp.int32)

    for label, seg_ids in (("causal", None), ("packed", seg)):
        def fwd_bwd(fn, q, k, v):
            out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=True, segment_ids=seg_ids), q, k, v)
            return (out, *vjp(do.astype(out.dtype)))

        wrapped = lambda *a, **kw: cudnn_attention(*a, **kw, implementation=impl)  # noqa: E731
        got = jax.jit(lambda q, k, v: fwd_bwd(wrapped, q, k, v))(q, k, v)
        with jax.default_matmul_precision("highest"):
            f32 = lambda x: x.astype(jnp.float32)
            ref = jax.jit(lambda q, k, v: fwd_bwd(xla_attention, q, k, v))(f32(q), f32(k), f32(v))
        shape = f"B{b} S{s} {hq}q/{hkv}kv hd{hd} bf16"
        _check(f"{impl} attention {label} out [{shape}]", _rel_err(got[0], ref[0]), TOL_OUT)
        for name, g, r in zip(("dQ", "dK", "dV"), got[1:], ref[1:]):
            _check(f"{impl} attention {label} {name} [{shape}]", _rel_err(g, r), TOL_GRAD)

    n_slots, ps, max_pages = sizes.paged_shape
    rng = np.random.default_rng(1)
    rows = 2 * n_slots * max_pages + 1
    kp = jnp.asarray(rng.standard_normal((rows, ps, hkv * hd)), jnp.bfloat16)
    vp = jnp.asarray(rng.standard_normal((rows, ps, hkv * hd)), jnp.bfloat16)
    qd = jnp.asarray(rng.standard_normal((n_slots, hq, hd)), jnp.bfloat16)
    table = jnp.asarray(rng.permutation(rows - 1)[: n_slots * max_pages].reshape(n_slots, max_pages), jnp.int32)
    # ragged: 1 token, exactly one page, a full window, and everything between
    lens = rng.integers(1, max_pages * ps + 1, n_slots)
    lens[:3] = (1, ps, max_pages * ps)
    lens = jnp.asarray(lens, jnp.int32)
    got = paged_attention_triton(qd, kp, vp, table, lens, interpret=interpret)
    with jax.default_matmul_precision("highest"):
        f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
        ref = jax.jit(paged_attention)(f32(qd), f32(kp), f32(vp), table, lens)
    _check(f"triton paged decode [{n_slots} slots, page {ps}, {max_pages} pages, {hq}q/{hkv}kv, bf16]",
           _rel_err(got, ref), TOL_OUT)


def phase_logits_parity(paths: dict, sizes: Sizes) -> None:
    """The extended model's forward in bf16 (auto attention) against float32
    (einsum attention, "highest" precision) on the same tokens."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_jax.checkpoint import Checkpointer
    from ssi_jax.models.configs import get_model_config
    from ssi_jax.models.llama3 import forward, logits

    cfg = get_model_config(sizes.model_config).copy()
    cfg.n_dsus = sizes.n_dsus
    cfg.modality_tokens = True
    ckpt = Checkpointer(checkpoint_dir=paths["ext"], output_dir=WORK / "unused",
                        model_expectations=cfg.checkpoint_expectations)
    params = ckpt.load_params(cfg, dtype=jnp.float32)
    tokens = jnp.asarray(np.random.default_rng(2).integers(0, cfg.vocab_size, sizes.logits_tokens), jnp.int32)

    def run(p, attn_impl):
        return logits(p, forward(p, tokens, cfg, attn_impl=attn_impl, remat=False))

    bf16 = jax.jit(lambda p: run(p, "auto"))(jax.tree.map(lambda x: x.astype(jnp.bfloat16), params))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p: run(p, "xla"))(params)
    got = np.asarray(bf16, np.float32)
    if got.shape != (*sizes.logits_tokens, cfg.vocab_size) or not np.isfinite(got).all():
        raise AssertionError(f"bad logits: shape {got.shape}, finite {np.isfinite(got).all()}")
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(np.asarray(ref), -1)))
    log(f"logits {sizes.model_config} bf16 vs float32 on {sizes.logits_tokens}: argmax agreement {agree:.3f}")
    _check(f"{sizes.model_config} forward logits bf16 vs float32", _rel_err(got, ref), TOL_LOGITS)


def _train_cfg(paths: dict, sizes: Sizes, out: Path, max_steps: int, model_dir: Path | None = None,
               training_state: Path | None = None, deterministic: bool = False):
    from ssi_jax.config import compose

    model_dir = model_dir or paths["ext"]
    data = paths["data"]
    overrides = [
        "data=cpt/mls-hubert_large_ll60k-layer_22",
        f"model_config={sizes.model_config}",
        f"speech.n_dsus={sizes.n_dsus}",
        f"dtype={sizes.dtype}",
        "parallel.dp=1",
        "parallel.tp=1",
        f"tokenizer.path={model_dir / 'original' / 'tokenizer.model'}",
        f"tokenizer.max_seq_len={sizes.seq_len}",
        f"gradient_accumulation_steps={sizes.accum}",
        f"data.train.dataloader.batch_size={sizes.micro_batch}",
        f"data.dev.dataloader.batch_size={sizes.micro_batch}",
        f"max_steps={max_steps}",
        f"save_steps={max_steps}",
        f"eval_steps={max_steps}",
        "log_interval=1",
        "wandb.enabled=false",
        f"optimizer.lr={sizes.lr}",
        f"checkpointer.checkpoint_dir={model_dir}",
        f"checkpointer.output_dir={out}",
        f"deterministic_ops={str(deterministic).lower()}",
    ]
    for split in ("train", "dev"):
        overrides += [f"data.{split}.dataset.source=json", f"data.{split}.dataset.split=train",
                      f"+data.{split}.dataset.data_files={data / (split + '.jsonl')}"]
    cfg = compose(REPO / "conf", "cpt", overrides)
    cfg.lr_scheduler = None  # constant lr: the same schedule for full and resumed runs
    if training_state is not None:
        cfg.checkpointer.training_state_checkpoint = str(training_state)
    return cfg


def _run_trainer(cfg, memory_analysis: bool = False) -> list[float]:
    import jax
    import jax.numpy as jnp

    from ssi_jax.train import Trainer

    t = Trainer(cfg)
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t0 = time.time()
    t.train()
    wall = time.time() - t0
    if memory_analysis:
        a, b, s = cfg.gradient_accumulation_steps, t.geometry.batch_size, cfg.tokenizer.max_seq_len
        sds = jax.ShapeDtypeStruct((a, b, s), jnp.int32, sharding=t._batch_sharding)
        mem = t.train_step.lower(t.state, sds, sds, None, None).compile().memory_analysis()
        log(f"train step memory_analysis: {mem}")
    t.cleanup()
    log(f"trainer: {len(losses)} steps in {wall:.1f} s (compile included), losses {losses}")
    return losses


def phase_train(paths: dict, sizes: Sizes, work: Path) -> tuple[list[float], Path]:
    import numpy as np

    out = work / "run_full"
    losses = _run_trainer(_train_cfg(paths, sizes, out, sizes.train_steps), memory_analysis=True)
    if len(losses) != sizes.train_steps or not np.isfinite(losses).all():
        raise AssertionError(f"expected {sizes.train_steps} finite losses, got {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    step_dir = out / f"step_{sizes.train_steps}"
    if not (step_dir / "model.safetensors").is_file() and not list(step_dir.glob("*.safetensors")):
        raise AssertionError(f"no checkpoint written at {step_dir}")
    log(f"train {sizes.model_config} CPT window {sizes.micro_batch}x{sizes.accum}x{sizes.seq_len}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, saved {step_dir.name}")
    return losses, step_dir


def phase_resume(paths: dict, sizes: Sizes, work: Path) -> bool:
    """Bitwise resume under ``deterministic_ops=true``: the other phases run the
    launchers' default build."""
    half = sizes.train_steps // 2
    full_losses = _run_trainer(_train_cfg(paths, sizes, work / "run_straight", sizes.train_steps, deterministic=True))
    out_a = work / "run_half"
    losses_a = _run_trainer(_train_cfg(paths, sizes, out_a, half, deterministic=True))
    losses_b = _run_trainer(_train_cfg(
        paths, sizes, work / "run_resumed", sizes.train_steps,
        model_dir=out_a / f"step_{half}", training_state=out_a / "training_state.msgpack", deterministic=True,
    ))
    combined = losses_a + losses_b
    bitwise = combined == full_losses
    diff = max(abs(a - b) for a, b in zip(combined, full_losses)) if len(combined) == len(full_losses) else float("inf")
    log(f"resume (deterministic_ops) {half}+save+resume+{sizes.train_steps - half} vs {sizes.train_steps} straight: "
        f"bitwise={bitwise} max |loss diff|={diff:.3e} ({combined} vs {full_losses})")
    if not bitwise:
        raise AssertionError("resumed loss stream is not bit-identical to the uninterrupted run")
    return bitwise


def _http(url: str, body: dict) -> dict | list:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            return json.loads(r.read())
        events = []
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                events.append(json.loads(line[len("data: "):]))
        return events


def _top5_first_token_ok(params, cfg, prompt_ids: list[int], first: int) -> bool:
    """The answer's first greedy token is among the float32 reference's top 5
    (robust to bf16 near-ties, catches garbage)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_jax.models.llama3 import forward, logits

    toks = jnp.asarray([prompt_ids], jnp.int32)
    with jax.default_matmul_precision("highest"):
        p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        lg = logits(p32, forward(p32, toks, cfg, attn_impl="xla", remat=False))[0, -1]
    return int(first) in set(np.argsort(np.asarray(lg))[-5:].tolist())


def phase_serve(step_dir: Path, sizes: Sizes) -> None:
    from ssi_jax.config import compose
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.serve import _chat_prompt_tokens, build_server, run_http_server

    cfg = compose(REPO / "conf", "serve", [
        f"model={step_dir}",
        f"model_config={sizes.model_config}",
        f"speech.n_dsus={sizes.n_dsus}",
        f"dtype={sizes.dtype}",
        f"tokenizer.path={step_dir / 'original' / 'tokenizer.model'}",
        f"batch_size={sizes.slots}",
        f"max_cache_len={sizes.max_context}",
        "server.port=0",
    ])
    server = build_server(cfg)
    engine, tok = server.engine, server.tokenizer
    log(f"engine: decode={engine.attn_impl} prefill={engine.prefill_impl} slots={engine.n_slots} "
        f"page={engine.page_size} max_context={engine.max_context}")
    server.start()
    httpd = run_http_server(server, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        prompt = "the house of the"
        t0 = time.time()
        comp = _http(url + "/v1/completions", {"prompt": prompt, "max_tokens": 16, "temperature": 0})
        ids = comp["choices"][0]["token_ids"]
        log(f"/v1/completions greedy: {len(ids)} tokens in {time.time() - t0:.2f} s (compile included) "
            f"finish={comp['choices'][0]['finish_reason']}")
        prompt_ids = tok.encode(prompt, add_bos=True, add_eos=False)
        if not ids or not _top5_first_token_ok(engine.params, engine.cfg, prompt_ids, ids[0]):
            raise AssertionError(f"completion tokens {ids} disagree with the float32 reference")
        messages = [{"role": "user", "content": "the world"}]
        chat = _http(url + "/v1/chat/completions", {"messages": messages, "max_tokens": 16})
        cids = chat["choices"][0]["token_ids"]
        log(f"/v1/chat/completions: {len(cids)} tokens finish={chat['choices'][0]['finish_reason']}")
        if not cids or not _top5_first_token_ok(engine.params, engine.cfg, _chat_prompt_tokens(tok, messages), cids[0]):
            raise AssertionError(f"chat tokens {cids} disagree with the float32 reference")
        events = _http(url + "/v1/completions", {"prompt": prompt, "max_tokens": 16, "stream": True})
        sids = [t for e in events[:-1] for t in e["choices"][0]["token_ids"]]
        log(f"/v1/completions stream: {len(events)} events, {len(sids)} tokens, same as non-streamed: {sids == ids}")
        if sids != ids or events[-1]["usage"]["completion_tokens"] != len(ids):
            raise AssertionError("streamed greedy tokens differ from the non-streamed answer")
    finally:
        httpd.shutdown()
        server.stop()

    base_engine_kwargs = dict(n_slots=sizes.slots, max_context=sizes.max_context)
    prompts = [tok.encode(p, add_bos=True, add_eos=False)
               for p in ("the house", "a new world", "the school of the", "people")]
    sp = SamplingParams(temperature=0.0, max_tokens=16, stop_token_ids=())
    int8 = PagedDecodeEngine(engine.params, engine.cfg, pad_id=tok.pad_id, quantize="int8", **base_engine_kwargs)
    t0 = time.time()
    outs = int8.generate_batch(prompts, sp)
    n = sum(len(o["token_ids"]) for o in outs)
    ok = all(_top5_first_token_ok(engine.params, engine.cfg, p, o["token_ids"][0]) for p, o in zip(prompts, outs))
    log(f"int8 engine: {len(prompts)} prompts, {n} tokens in {time.time() - t0:.2f} s (compile included); "
        f"first tokens in the float32 top-5: {ok}")
    if n != 16 * len(prompts) or not ok:
        raise AssertionError("int8 engine output is wrong")


# ---------------------------------------------------------------------- four cards


TOL_F32 = 1e-4  # float32 "highest" on both sides: only the reduction order differs


def _device_memory(label: str) -> None:
    import jax

    for d in jax.local_devices():
        st = d.memory_stats() or {}
        log(f"{label} device {d.id}: bytes_in_use {st.get('bytes_in_use')} peak {st.get('peak_bytes_in_use')}")


def _assert_sharded(tree, label: str) -> None:
    """Every large leaf is split across the devices: each holds only its shard."""
    import jax

    n_devices = max(len(leaf.sharding.device_set) for leaf in jax.tree.leaves(tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if leaf.size < 1 << 20:
            continue
        shard_bytes = {s.device.id: s.data.nbytes for s in leaf.addressable_shards}
        if max(shard_bytes.values()) >= leaf.nbytes:
            raise AssertionError(f"{label}: {jax.tree_util.keystr(path)} is not sharded ({shard_bytes})")
    log(f"{label}: every leaf >= 1 Mi elements is sharded across {n_devices} devices")


def _zipf_tokens(vocab: int, shape: tuple, seed: int = 0):
    """A learnable token stream: Zipf-distributed ids (a first step learns the unigram)."""
    import numpy as np

    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    return np.random.default_rng(seed).choice(vocab, shape, p=probs / probs.sum()).astype(np.int32)


def _sharded_train_setup(cfg, mesh, dtype, fsdp: bool, remat, accum_dtype, lr: float = LR):
    """Random-init train state placed like ``Trainer`` places it (FSDP shards
    params and moments over dp), and the jitted step that keeps that layout."""
    import jax
    import jax.numpy as jnp

    from ssi_jax.models.llama3 import init_params
    from ssi_jax.parallel import opt_state_shardings, param_shardings
    from ssi_jax.train.lr_schedule import constant_schedule
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    init = lambda k: init_params(cfg, k, dtype)  # noqa: E731
    abstract = jax.eval_shape(init, jax.random.key(0))
    p_sh = param_shardings(mesh, abstract, fsdp=fsdp)
    o_sh = opt_state_shardings(mesh, abstract, zero1=fsdp)
    opt_cfg = AdamWConfig(lr=lr, mu_dtype=dtype, nu_dtype=dtype)
    params = jax.jit(init, out_shardings=p_sh)(jax.random.key(0))
    state = {
        "params": params,
        "opt_state": jax.jit(lambda p: init_opt_state(p, opt_cfg), out_shardings=o_sh)(params),
        "step": jnp.zeros((), jnp.int32),
    }
    step = make_train_step(
        cfg, opt_cfg, constant_schedule(lr), clip_grad_norm=1.0e9, remat=remat, chunk_size=2048,
        grad_accum_dtype=accum_dtype,
        state_shardings={"params": p_sh, "opt_state": o_sh} if fsdp else None,
    )
    return state, step


def phase_fsdp_step_vs_one_card(sizes: Sizes) -> None:
    """One train step (1B on the card) under dp=2 x tp=2 FSDP against the same step on one
    card, both float32 under "highest": the loss, the global grad norm, and the
    gradient leaf by leaf. After a first AdamW step from zero moments the first
    moment is exactly (1 - b1) * grad (clipping is off), so each leaf of ``mu``
    is compared as ||mu_fsdp - mu_one|| / ||mu_one||: a gradient routed to the
    wrong leaf or permuted inside one fails it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_jax.models.configs import get_model_config
    from ssi_jax.parallel import batch_sharding, make_mesh

    cfg = get_model_config(sizes.model_config).copy()
    cfg.n_dsus = sizes.n_dsus
    cfg.modality_tokens = True
    toks = _zipf_tokens(cfg.vocab_size, (2, sizes.micro_batch, sizes.seq_len))
    results = {}
    with jax.default_matmul_precision("highest"):
        for label, (dp, tp, fsdp) in (("1 card", (1, 1, False)), ("dp2 x tp2 fsdp", (2, 2, True))):
            mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
            state, step = _sharded_train_setup(cfg, mesh, jnp.float32, fsdp, "save_qkv_mlp", jnp.float32)
            batch = jax.device_put(toks, batch_sharding(mesh))
            state, m = step(state, batch, batch)
            if fsdp:
                _assert_sharded(state["params"], f"{sizes.model_config} fsdp params")
                _assert_sharded(state["opt_state"]["mu"], f"{sizes.model_config} fsdp first moments")
                _device_memory(f"{sizes.model_config} fsdp")
            results[label] = (float(m["loss_sum"]) / float(m["num_tokens"]), float(m["grad_norm"]),
                              jax.device_get(state["opt_state"]["mu"]))
            del state, step, batch
    (l1, g1, mu1), (l4, g4, mu4) = results.values()
    dl, dg = abs(l4 - l1) / abs(l1), abs(g4 - g1) / abs(g1)
    leaf_err = {
        jax.tree_util.keystr(path): float(np.linalg.norm(b - a) / max(float(np.linalg.norm(a)), 1e-30))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mu1), jax.tree.leaves(mu4))
    }
    worst = max(leaf_err, key=leaf_err.get)
    log(f"{sizes.model_config} fsdp step vs one card (float32 highest, tolerance {TOL_F32:.0e} on each): loss {l1:.7f} vs {l4:.7f} "
        f"(rel {dl:.2e}), grad norm {g1:.6f} vs {g4:.6f} (rel {dg:.2e}), gradient per leaf: worst "
        f"||diff|| / ||one card|| {leaf_err[worst]:.2e} at {worst} over {len(leaf_err)} leaves")
    if not (dl <= TOL_F32 and dg <= TOL_F32 and leaf_err[worst] <= TOL_F32):
        raise AssertionError("dp2 x tp2 FSDP step disagrees with the one-card step")


def phase_tp_decode_vs_one_card(sizes: Sizes, tp: int = 4) -> None:
    """Greedy paged decode with tp-sharded weights and KV pools against one card."""
    import jax
    import jax.numpy as jnp

    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.configs import get_model_config
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.parallel import make_mesh

    cfg = get_model_config(sizes.model_config).copy()
    cfg.n_dsus = sizes.n_dsus
    cfg.modality_tokens = True
    prompts = [p.tolist() for p in _zipf_tokens(cfg.base_vocab_size_txt, (6, 40), seed=3)]
    sp = SamplingParams(temperature=0.0, max_tokens=16, stop_token_ids=())
    kw = dict(n_slots=sizes.slots, max_context=sizes.max_context, attn_impl="gather")
    with jax.default_matmul_precision("highest"):
        params = jax.jit(lambda k: init_params(cfg, k, jnp.float32))(jax.random.key(1))
        one = PagedDecodeEngine(params, cfg, pad_id=0, **kw)
        want = [o["token_ids"] for o in one.generate_batch(prompts, sp)]
        del one
        mesh = make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
        eng = PagedDecodeEngine(params, cfg, pad_id=0, mesh=mesh, **kw)
        _assert_sharded(eng.params["layers"], f"tp={tp} decode weights")
        _assert_sharded(eng.pools, f"tp={tp} KV pools")
        got = [o["token_ids"] for o in eng.generate_batch(prompts, sp)]
    same = sum(a == b for a, b in zip(got, want))
    log(f"tp={tp} paged decode vs one card (float32 highest): {same}/{len(prompts)} greedy sequences identical")
    if got != want:
        raise AssertionError(f"tp decode differs from one card: {got} vs {want}")


def phase_8b_fsdp_train(model_config: str = "llama3_1_8b", steps: int = 4, batch: int = 8, seq: int = 768,
                        lr: float = 1e-5) -> None:
    """A few train steps on one fixed batch with params and moments FSDP-sharded
    over all cards. The 8B's first Adam steps at the 1B's lr overshoot (each
    weight moves by ~lr, coherently over 4096 inputs), hence a smaller lr."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssi_jax.models.configs import get_model_config
    from ssi_jax.parallel import batch_sharding, make_mesh

    cfg = get_model_config(model_config).copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    mesh = make_mesh(dp=len(jax.devices()), tp=1)
    state, step = _sharded_train_setup(cfg, mesh, jnp.bfloat16, True, "full", jnp.bfloat16, lr=lr)
    _assert_sharded(state["params"], f"{model_config} fsdp params")
    _assert_sharded(state["opt_state"], f"{model_config} fsdp moments")
    toks = jax.device_put(_zipf_tokens(cfg.vocab_size, (1, batch, seq), seed=10), batch_sharding(mesh))
    losses = []
    t0 = time.time()
    for _ in range(steps):
        state, m = step(state, toks, toks)
        losses.append(float(m["loss_sum"]) / float(m["num_tokens"]))
    log(f"{model_config} fsdp train over {len(jax.devices())} cards, batch {batch}x{seq}: losses {losses} "
        f"in {time.time() - t0:.1f} s (compile included)")
    _device_memory(f"{model_config} fsdp")
    if not (np.isfinite(losses).all() and all(b < a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"{model_config} loss not finite and falling: {losses}")


def phase_four_cards(sizes: Sizes = FULL, big_model: str = "llama3_1_8b") -> None:
    phase_fsdp_step_vs_one_card(sizes)
    phase_tp_decode_vs_one_card(sizes)
    phase_8b_fsdp_train(big_model)


# --------------------------------------------------------------------------- main


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def main(argv: list[str] | None = None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true", help="run only the four-card path (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if not (REPO / "ssi_jax" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform!r}; refusing to run", file=sys.stderr)
        return 3
    CARD = _card() or "unknown card"
    print(CARD, flush=True)  # nvidia-smi name, power limit
    n_needed = 4 if args.four_cards else 1
    if len(jax.devices()) < n_needed:
        print(f"needs {n_needed} GPUs, found {len(jax.devices())}", file=sys.stderr)
        return 3
    os.environ.setdefault("SSI_JAX_HOME", str(WORK))
    os.environ.setdefault("HF_HOME", str(WORK / "hf"))
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)

    t0 = time.time()
    info = phase_environment()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_imports()
        paths = phase_assets(WORK, FULL)
        phase_kernel_parity(FULL)
        phase_logits_parity(paths, FULL)
        _losses, step_dir = phase_train(paths, FULL, WORK)
        phase_resume(paths, FULL, WORK)
        phase_serve(step_dir, FULL)
    log(f"all phases passed in {time.time() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    device = {k: info[k] for k in ("platform", "kind", "count")}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
