#!/usr/bin/env python
"""Hardware WER drive: the FULL reference pipeline end-to-end on the attached GPU.

extend_llama3_2 -> train_sft -> generate (bf16 AND int8) -> wer_parity,
producing ``wer_parity.json`` artifacts with a real WER value and the
int8-vs-bf16 WER delta (the acceptance gate named in conf/generate.yaml and
bench_decode.py).

Offline constraints (zero egress, no hub weights/data) are met by synthesizing
the INPUTS while keeping every pipeline stage real and at real scale:

- a 128,000-entry base ``tokenizer.model`` (valid tiktoken BPE: byte tokens,
  UTF-8 intermediate merges so the PUA extension merges resolve, prefix-chain
  merges for the task vocabulary, deterministic filler ranks) — the same
  vocab arithmetic as Llama 3.2 (128000 + 256 specials);
- a random-init HF checkpoint (fp32 safetensors, config.json,
  original/{tokenizer.model,params.json}). Default architecture is the
  pilot-scale llama3_2_100m (same geometry family: head_dim 64, GQA, RoPE
  scaling, full 128,256-token vocab arithmetic) — a from-random-init model
  must CONVERGE on the drive's token budget for the WER number to certify
  the pipeline; ``--model-config llama3_2_1b`` restores the full-scale
  architecture;
- a deterministic, *learnable* DSU-ASR corpus: one position-free DSU per
  word (bijective codebook, fixed utterance length, no within-utterance
  repeats; ``deduplicate`` stays lossless); 256k DISTINCT rows = one visit
  per row, so utterance memorization cannot reduce loss (see --n-train).
  Utterances are Zipf-weighted word sequences, transcripts are their text.
  An SFT run learns the codebook the way MLS SFT learns real ASR (ref task:
  scripts/train_sft.py on mls-hubert_large_ll60k-layer_22, n_dsus=5000).

Silent truncation (the ~67-token reference system prompt overflowing
max_seq_len and amputating every answer) once held WER at a plateau; it is
caught by comparing loss against the task's closed-form speech-blind floor,
and a pre-train guard (assert_no_truncation) now makes that failure impossible.

Every stage runs through the REAL CLIs (scripts/extend_llama3_2.py,
scripts/train_sft.py, scripts/generate.py, scripts/wer_parity.py) with
config-surface overrides only — nothing here has a private code path.

The parent process never starts a JAX backend (assets are built with numpy):
the JAX children below get the card to themselves.

Usage (on the GPU host):

    python tools/wer_drive.py --workdir .wer_drive                      # full drive
    python tools/wer_drive.py --workdir /tmp/wd --smoke                  # wiring check
    python tools/wer_drive.py ... --phases assets,extend,train           # partial

Artifacts land in ``--artifacts-dir`` (default <workdir>/artifacts): the two
wer_parity.json files plus summary.json with the full fingerprint.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
from pathlib import Path
import shutil
import subprocess
import sys
import time

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

logging.basicConfig(
    format="[%(asctime)s][wer_drive][%(levelname)s] - %(message)s",
    level=logging.INFO,
    stream=sys.stdout,
)
LOGGER = logging.getLogger("wer_drive")

SEED = 20260819
BASE_VOCAB = 128_000
# Fixed utterance length: a constant speech->text alignment offset (see
# build_corpus for why this is load-bearing for from-scratch convergence)
N_WORDS = 10

# Task vocabulary: common English words (plus a few words whose British
# spellings exercise the vendored normalizer mapping on both sides).
WORDS = """
the of and to in is was he for it with as his on be at by had not are but from
or have an they which one you were all her she there would their we him been
has when who will no more if out so up said what its about than into them can
only other time new some could these two may first then do any like my now
over such our man me even most made after also did many off before must well
back through years much where your way down should because each just those
people too how little good world make very year still see own work men day get
here old life both between under never same another know while last might us
great old year came right used take three states himself few house use during
without again place american around however home small found mrs thought went
say part once general high upon school every don't does got united left number
course war until always away something fact though water less public put think
almost hand enough far took head yet government system better set told nothing
night end why called didn't eyes find going look asked later knew point next
city business case give group toward young let days true face others since
room mother social present friend power rather large family often kind four
among children however against state become interest big open possible
certain order early moved money ago second door white remember program
believe whole question began least word hours feel among side voice along
thing area want members mind country service best father door keep problem
music light education study turned want national care form given history
several change until help line fire name nature deal physical sense moment
free road colour theatre organise favourite centre behaviour honour analyse
programme labour neighbour travelled marvellous
""".split()


def _dedupe(seq):
    seen = set()
    out = []
    for w in seq:
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


WORDS = _dedupe(WORDS)


# ------------------------------------------------------------------------------
# Phase 1: assets
# ------------------------------------------------------------------------------


def build_base_tokenizer(path: Path, words: list[str], vocab_size: int = BASE_VOCAB) -> None:
    """Write a valid ``vocab_size``-entry tiktoken BPE file (128,000 = Llama 3.2's).

    Layout (ranks ascending): 256 byte tokens; the 128 two-byte UTF-8
    intermediate merges for the PUA lead bytes 0xEE/0xEF (so the extension's
    appended 3-byte PUA tokens are reachable by byte-pair merging — tiktoken
    can only form a token if both halves of some split exist at lower ranks);
    prefix-chain merges for every task word (with and without leading space,
    sorted by length so each prefix outranks its extension); deterministic
    filler byte strings up to exactly ``vocab_size`` (valid, unreachable,
    harmless — real Llama vocab mass our task never touches). A 256-entry file
    is the byte tokens alone.
    """
    tokens: list[bytes] = [bytes([i]) for i in range(256)]
    seen = set(tokens)

    def add(tok: bytes) -> None:
        if tok not in seen:
            seen.add(tok)
            tokens.append(tok)

    # UTF-8 intermediates for PUA chars U+E000..U+FFFF (lead bytes 0xEE, 0xEF)
    for lead in (0xEE, 0xEF):
        for b2 in range(0x80, 0xC0):
            add(bytes([lead, b2]))

    # Prefix-chain merges: every prefix (len >= 2) of each word variant, length-sorted
    merges: set[bytes] = set()
    for w in words:
        for variant in (w, " " + w):
            enc = variant.encode()
            for k in range(2, len(enc) + 1):
                merges.add(enc[:k])
    for tok in sorted(merges, key=lambda t: (len(t), t)):
        add(tok)

    # Filler: 2-byte high-lead pairs, then 3-byte 0xF8..0xFD-lead triples.
    for a in range(0x80, 0x100):
        for b in range(0x100):
            if len(tokens) >= vocab_size:
                break
            add(bytes([a, b]))
    for lead in range(0xF8, 0xFE):
        for a in range(0x100):
            for b in range(0x100):
                if len(tokens) >= vocab_size:
                    break
                add(bytes([lead, a, b]))

    if len(tokens) < vocab_size:
        raise RuntimeError(f"only {len(tokens)} tokens constructed")
    tokens = tokens[:vocab_size]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for rank, tok in enumerate(tokens):
            f.write(base64.b64encode(tok).decode() + f" {rank}\n")
    LOGGER.info(f"base tokenizer.model: {len(tokens)} entries -> {path}")


def init_params_numpy(cfg, seed: int = SEED) -> dict:
    """``models.llama3.init_params`` in numpy (same layout and scales, fp32):
    builds a base checkpoint without starting a JAX backend, so a launcher that
    runs JAX children on the card keeps its own process off the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f, hd = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    hq, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size

    def norm_init(shape, fan_in):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(fan_in**-0.5)
        return x

    extra = {} if cfg.tied_embeddings else {"lm_head": norm_init((v, d), d)}
    return extra | {
        "embed": norm_init((v, d), d),
        "layers": {
            "attn_norm": np.ones((nl, d), np.float32),
            "wq": norm_init((nl, d, hq * hd), d),
            "wk": norm_init((nl, d, hkv * hd), d),
            "wv": norm_init((nl, d, hkv * hd), d),
            "wo": norm_init((nl, hq * hd, d), d),
            "mlp_norm": np.ones((nl, d), np.float32),
            "w_gate": norm_init((nl, d, f), d),
            "w_up": norm_init((nl, d, f), d),
            "w_down": norm_init((nl, f, d), f),
        },
        "final_norm": np.ones((d,), np.float32),
    }


def build_base_checkpoint(model_dir: Path, model_config: str, seed: int = SEED) -> None:
    """Random-init base checkpoint in HF format (fp32 like the reference's
    base load — ref: scripts/extend_llama3_2.py:166). numpy only: no JAX backend."""
    import numpy as np
    from safetensors.numpy import save_file

    from ssi_jax.checkpoint.convert import internal_to_hf
    from ssi_jax.models.configs import get_model_config

    cfg = get_model_config(model_config).copy()  # n_dsus=0: base (unextended) model
    (model_dir / "original").mkdir(parents=True, exist_ok=True)

    hf_state = internal_to_hf(init_params_numpy(cfg, seed), cfg, xp=np)
    save_file(
        {k: np.ascontiguousarray(v) for k, v in hf_state.items()},
        str(model_dir / "model.safetensors"),
    )
    bos = cfg.base_vocab_size_txt
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "vocab_size": cfg.vocab_size,
        "bos_token_id": bos,
        "eos_token_id": bos + 1,
        "tie_word_embeddings": cfg.tied_embeddings,
        "rope_theta": float(cfg.rope_base),
        "max_position_embeddings": cfg.max_seq_len,
    }
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    (model_dir / "generation_config.json").write_text(
        json.dumps({"bos_token_id": bos, "eos_token_id": bos + 1}, indent=2)
    )
    (model_dir / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}, indent=2))
    LOGGER.info(f"base {model_config} checkpoint (random init, fp32) -> {model_dir}")


def build_corpus(data_dir: Path, n_dsus: int, n_train: int, n_dev: int, n_test: int) -> dict:
    """Deterministic learnable DSU-ASR corpus: ONE position-free DSU per word.

    Design is driven by what a FROM-SCRATCH model can reliably master on a
    ~60M-token single-chip budget (the reference fine-tunes pretrained Llama;
    offline we must train the checkpoint we score):

    - ``codes[w]``: one code per word, a bijective 313-entry codebook —
      decode is a single-token embedding association, the easiest possible
      lookup;
    - words within an utterance are sampled WITHOUT replacement (Zipf-0.6
      weights still skew frequencies ACROSS utterances), so no code repeats
      inside an utterance: adjacent speech tokens always differ, which keeps
      ``deduplicate: true`` (the reference default, conf/common.yaml)
      lossless, and every prompt code is unambiguous;
    - every utterance is exactly ``N_WORDS`` words, so the speech token for
      word i sits at a CONSTANT relative offset from the answer token that
      must emit word i — alignment is a single fixed-offset attention hop,
      no counting or induction circuit required.

    History note: the round-4/5 plateaus (loss ~1.65-2.2 / WER 0.63) that
    motivated successive simplifications turned out to be silent row
    truncation (see assert_no_truncation), not task difficulty — with the
    guard in place this corpus trains to WER 0.00 from random init. The
    simplifications are kept: they make the task's blind-floor arithmetic
    closed-form (one token per word), which is what exposed the truncation.
    Every pipeline stage (extend -> SFT -> paged decode -> WER) stays real
    and at real vocab scale.
    """
    import numpy as np

    rng = np.random.default_rng(SEED)
    if n_dsus < len(WORDS):
        raise ValueError(f"n_dsus={n_dsus} < {len(WORDS)} words")
    perm = rng.permutation(n_dsus)[: len(WORDS)]
    codes: dict[str, int] = {w: int(c) for w, c in zip(WORDS, perm)}

    ranks = np.arange(1, len(WORDS) + 1, dtype=np.float64)
    p = 1.0 / ranks**0.6
    p /= p.sum()

    def make_rows(n: int, tag: str) -> list[dict]:
        rows = []
        for i in range(n):
            ws = [WORDS[j] for j in rng.choice(len(WORDS), N_WORDS, replace=False, p=p)]
            speech = [codes[w] for w in ws]
            rows.append({"ID": f"{tag}_{i}", "speech_tokens": speech, "transcript": " ".join(ws)})
        return rows

    data_dir.mkdir(parents=True, exist_ok=True)
    splits = {"train": make_rows(n_train, "tr"), "dev": make_rows(n_dev, "dv"), "test": make_rows(n_test, "te")}
    for name, rows in splits.items():
        with open(data_dir / f"{name}.jsonl", "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    with open(data_dir / "refs_test.jsonl", "w") as f:
        for r in splits["test"]:
            f.write(json.dumps({"transcript": r["transcript"]}) + "\n")
    (data_dir / "codebook.json").write_text(json.dumps(codes, indent=0))
    LOGGER.info(
        f"corpus: {n_train}/{n_dev}/{n_test} rows, {len(WORDS)} words, "
        f"{N_WORDS} words/utterance, bijective 1-code-per-word -> {data_dir}"
    )
    return codes


# ------------------------------------------------------------------------------
# Phase runners (real CLIs, config-surface overrides only)
# ------------------------------------------------------------------------------


def run(cmd: list[str], env: dict, log_to: Path | None = None) -> None:
    LOGGER.info("RUN " + " ".join(map(str, cmd)))
    t0 = time.time()
    if log_to is not None:
        with open(log_to, "a") as f:
            proc = subprocess.run(list(map(str, cmd)), env=env, stdout=f, stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            tail = log_to.read_text().splitlines()[-40:]
            raise RuntimeError(f"command failed ({proc.returncode}):\n" + "\n".join(tail))
    else:
        subprocess.run(list(map(str, cmd)), env=env, check=True)
    LOGGER.info(f"done in {time.time() - t0:.1f}s")


def assert_no_truncation(ext_dir: Path, data_dir: Path, max_seq_len: int,
                         model_overrides: list[str], data_overrides: list[str]) -> None:
    """Fail fast if any tokenized train row would be truncated at max_seq_len.

    Truncation silently amputates the transcript (the answer sits at the end of
    the sequence), leaving nothing supervised but headers and unpredictable DSU
    codes — the drive then trains to the DSU-marginal loss floor and WER never
    moves. Dataset settings (system prompt, train_on_input, dedup, column_map)
    are read through the REAL composed config so this guard cannot drift from
    what scripts/train_sft.py will actually do.
    """
    from ssi_jax.config import compose
    from ssi_jax.data.sft import SFTDataset
    from ssi_jax.tokenizer import setup_llama3_tokenizer

    cfg = compose(str(REPO / "conf"), "sft",
                  ["data=sft/mls-hubert_large_ll60k-layer_22", *model_overrides, *data_overrides,
                   f"tokenizer.max_seq_len={max_seq_len}"])
    dcfg = cfg.data.train.dataset
    tok, _ = setup_llama3_tokenizer(ext_dir / "original" / "tokenizer.model",
                                    max_seq_len=max_seq_len, verbose=False)
    ds = SFTDataset(
        model_tokenizer=tok,
        source="json", data_files=str(data_dir / "train.jsonl"), split="train",
        deduplicate=bool(dcfg.deduplicate),
        use_modality_tokens=bool(dcfg.use_modality_tokens),
        train_on_input=bool(dcfg.train_on_input),
        column_map=dict(dcfg.column_map) if dcfg.column_map else None,
        new_system_prompt=dcfg.new_system_prompt,
        n_samples=300,
    )
    n = min(300, len(ds))
    worst = max(len(ds[i]["tokens"]) for i in range(n))
    if worst >= max_seq_len:
        raise RuntimeError(
            f"tokenized rows hit max_seq_len={max_seq_len} (longest of {n} sampled = {worst}): "
            "the transcript would be truncated away — raise --max-seq-len"
        )
    LOGGER.info(f"truncation guard: longest of {n} sampled rows = {worst} < max_seq_len={max_seq_len}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", type=Path, default=REPO / ".wer_drive")
    ap.add_argument("--artifacts-dir", type=Path, default=None, help="default: <workdir>/artifacts")
    ap.add_argument("--phases", default="assets,extend,train,generate,score,summary",
                    help="comma-separated subset of assets,extend,train,generate,score,summary")
    ap.add_argument("--n-dsus", type=int, default=5000)
    ap.add_argument(
        "--model-config",
        default="llama3_2_100m",
        help="Architecture registry key (llama3_2_100m converges on this budget; "
        "llama3_2_1b runs the full-scale architecture but cannot from random init)",
    )
    # One visit per row: 256k rows / (batch 32 x accum 2) = 4000 steps = ONE
    # epoch. Observed (12k rows x 21 epochs, a loss-curve finding): with repeated rows the
    # model MEMORIZES utterances instead of learning the codebook — train loss
    # 2.17 (below the 2.58 speech-blind floor) while dev loss sat AT the floor
    # (2.61). With every row distinct, utterance memorization cannot reduce
    # loss and the only descent direction is the DSU->word lookup itself.
    ap.add_argument("--n-train", type=int, default=256_000)
    ap.add_argument("--n-dev", type=int, default=192)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=4000)
    ap.add_argument("--eval-steps", type=int, default=250)
    # 64-row/16k-token optimizer window; at 100M a 32-row micro-batch fits the
    # chip (the 1B OOMed at 32x256 and needed micro-batch 16 x accum 4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=200)
    # Row budget must include the ~67-token reference system prompt
    # (conf/data/_sft_base.yaml new_system_prompt — none of its words are in
    # the task vocabulary, so it tokenizes near byte-level): headers + system
    # + 10 speech + 10-word transcript ~= 109 tokens, worst case (every word a
    # 3-token contraction) ~= 129. Round-4/5 drives ran at 96: every row was
    # TRUNCATED mid-answer, the model never saw one transcript token, and loss
    # sat exactly at the DSU-marginal floor (2.17 = 10 x 5.41 nats / 25
    # supervised tokens) — the real cause of the WER 0.63 plateaus.
    ap.add_argument("--max-seq-len", type=int, default=160)
    ap.add_argument("--decode-slots", type=int, default=48)
    ap.add_argument("--smoke", action="store_true", help="tiny wiring check (few steps, few rows)")
    args = ap.parse_args()

    if args.smoke:
        args.n_train, args.n_dev, args.n_test = 256, 32, 16
        args.max_steps, args.eval_steps = 8, 4
        args.warmup = 2

    phases = set(args.phases.split(","))
    W = args.workdir
    if args.artifacts_dir is None:
        args.artifacts_dir = W / "artifacts"
    W.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["SSI_JAX_HOME"] = str(W)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    py = sys.executable

    base_name = {
        "llama3_2_100m": "Llama-3.2-100M",
        "llama3_2_1b": "Llama-3.2-1B",
        "llama3_2_3b": "Llama-3.2-3B",
    }.get(args.model_config, args.model_config)
    base_dir = W / "models" / "base" / base_name
    ext_dir = W / "models" / "extended" / f"{base_name}-{args.n_dsus}-dsus"
    data_dir = W / "data"
    log = W / "drive.log"
    # identity overrides shared by train + generate (conf/common.yaml derives
    # extended_model_name / tokenizer path from base_model_name)
    model_overrides = [f"model_config={args.model_config}", f"base_model_name={base_name}"]

    if "assets" in phases:
        build_base_tokenizer(base_dir / "original" / "tokenizer.model", WORDS)
        build_base_checkpoint(base_dir, args.model_config)
        build_corpus(data_dir, args.n_dsus, args.n_train, args.n_dev, args.n_test)

    if "extend" in phases:
        if ext_dir.exists():
            shutil.rmtree(ext_dir)
        # sigma 1.0: the base is RANDOM-INIT (mean ~0), so the reference's 1e-5
        # covariance scale would collapse every DSU row onto one ~zero vector —
        # measured consequence: the model never learns to condition on the
        # speech tokens (loss plateaus at the text-side floor at 100M AND 1B)
        run([py, REPO / "scripts" / "extend_llama3_2.py",
             "--n_new_dsus", args.n_dsus, "--model-config", args.model_config,
             "--sigma-scaling", "1.0",
             "--input_dir", base_dir, "--output_dir", ext_dir],
            env, log)

    data_overrides = []
    for split, fname in (("train", "train.jsonl"), ("dev", "dev.jsonl")):
        data_overrides += [
            f"data.{split}.dataset.source=json",
            f"+data.{split}.dataset.data_files={data_dir / fname}",
            f"data.{split}.dataset.split=train",
        ]

    if "train" in phases:
        assert_no_truncation(ext_dir, data_dir, args.max_seq_len, model_overrides, data_overrides)
        run([py, REPO / "scripts" / "train_sft.py",
             "data=sft/mls-hubert_large_ll60k-layer_22",
             *model_overrides,
             *data_overrides,
             f"data.train.dataloader.batch_size={args.batch_size}",
             f"data.dev.dataloader.batch_size={args.batch_size}",
             f"gradient_accumulation_steps={args.grad_accum}",
             f"tokenizer.max_seq_len={args.max_seq_len}",
             f"optimizer.lr={args.lr}",
             f"lr_scheduler.num_warmup_steps={args.warmup}",
             f"max_steps={args.max_steps}",
             f"eval_steps={args.eval_steps}",
             f"save_steps={args.max_steps}",
             "log_interval=20",
             "clip_grad_norm=1.0",
             "wandb.enabled=false",
             "loss_chunk_size=3072",
             ], env, log)

    # find the newest checkpoint from the training run
    def latest_step_dir() -> Path:
        cands = sorted(W.glob("experiments/**/checkpoints/step_*"), key=lambda p: (p.stat().st_mtime, p.name))
        if not cands:
            raise FileNotFoundError(f"no step_N checkpoints under {W / 'experiments'}")
        return cands[-1]

    gen_variants = [("bf16", "null"), ("int8", "int8")]
    if "generate" in phases:
        step_dir = latest_step_dir()
        LOGGER.info(f"generating from {step_dir}")
        for tag, quant in gen_variants:
            # observability=true makes generate.py absorb every compile in an
            # in-process warmup pass, so the scored batch metric is
            # steady-state decode (the paged chunk program does not survive
            # the persistent compile cache across processes)
            out_root = W / f"gen_{tag}"
            if out_root.exists():
                shutil.rmtree(out_root)
            run([py, REPO / "scripts" / "generate.py",
                 f"model={step_dir}",
                 *model_overrides,
                 "data=sft/mls-hubert_large_ll60k-layer_22",
                 "data.test.dataset.source=json",
                 f"+data.test.dataset.data_files={data_dir / 'test.jsonl'}",
                 "data.test.dataset.split=train",
                 "gen.split=test",
                 f"gen.output_dir={out_root}",
                 f"batch_size={args.decode_slots}",
                 f"quantize_weights={quant}",
                 "observability=true",
                 ], env, log)

    if "score" in phases:
        for tag, _ in gen_variants:
            run([py, REPO / "scripts" / "wer_parity.py",
                 "--skip-generate", W / f"gen_{tag}" / "json" / "test",
                 "--refs-jsonl", data_dir / "refs_test.jsonl"],
                env, log)

    if "summary" in phases:
        art = args.artifacts_dir
        art.mkdir(parents=True, exist_ok=True)
        parity = {}
        for tag, _ in gen_variants:
            src = W / f"gen_{tag}" / "json" / "test" / "wer_parity.json"
            parity[tag] = json.loads(src.read_text())
            shutil.copy(src, art / f"wer_parity_{tag}.json")
        delta = abs(parity["int8"]["wer"] - parity["bf16"]["wer"])
        # steady-state decode throughput: generate.py (observability=true)
        # absorbs every compile in an in-process warmup pass before timing
        speeds = {}
        for tag, _ in gen_variants:
            gen = W / f"gen_{tag}" / "json" / "test" / "generations.jsonl"
            rows = [json.loads(line) for line in gen.read_text().splitlines()]
            m = rows[0].get("metrics") or {}
            speeds[tag] = m.get("batch_tokens_per_second")
        speeds["note"] = "steady-state (in-process compile warmup); includes prefill + weight staging"
        summary = {
            "pipeline": "extend_llama3_2 -> train_sft -> generate(paged) -> wer_parity",
            "hardware": _device_desc(),
            "model": f"{args.model_config} architecture, random init, extended +{args.n_dsus} DSUs (+2 modality)",
            "corpus": {
                "words": len(WORDS),
                "n_train": args.n_train,
                "n_test": args.n_test,
                "mapping": "one position-free DSU per word (bijective 313-entry codebook, "
                f"{N_WORDS} words/utterance, no within-utterance repeats, dedup-lossless)",
            },
            "train": {
                "max_steps": args.max_steps,
                "tokens_per_window": args.batch_size * args.grad_accum * args.max_seq_len,
                "lr": args.lr,
            },
            "wer_bf16": parity["bf16"]["wer"],
            "wer_int8": parity["int8"]["wer"],
            "int8_wer_delta": delta,
            "int8_within_acceptance": delta <= 0.1,
            "decode_tok_s": speeds,
            "spelling_map_sha256": parity["bf16"]["spelling_map_sha256"],
            "spelling_map_entries": parity["bf16"]["spelling_map_entries"],
            "seed": SEED,
            "recipe": "python tools/wer_drive.py  # deterministic: same seed -> same corpus/codebook",
        }
        (art / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
        LOGGER.info(json.dumps(summary, indent=2))


def _device_desc() -> str:
    """The card as ``nvidia-smi`` names it (name, power limit) — queried without
    JAX, so this process never reserves the card its children use."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        return out or "unknown"
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


if __name__ == "__main__":
    main()
