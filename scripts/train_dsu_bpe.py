#!/usr/bin/env python
"""Train BPE merges over DSU (speech-token) sequences for compressed-DSU runs.

Completes the reference's experiment-matrix compression axis ("using BPE to
compress the speech tokens or not" — ref: plans/Checkpointing - Consolidated
Plan.md:23,146-170 — planned, never implemented). Reads aligned rows from an
HF dataset (same schema the CPT pipeline consumes), converts each row's speech
tokens to the PUA string form via ``ssi_jax.speech.dsu2pua``, trains byte-level
BPE with whole-sequence pieces (merges span adjacent DSUs — the point of
compression), and writes a ``tokenizer.model``-format merges file plus a stats
JSON with the achieved compression ratio.

The output merges file is loadable by the tokenizer stack (tiktoken or the
native C++ core). NB compressed-DSU tokenizers must be loaded with a split
pattern that does NOT isolate \\p{Co} characters, or the merges never fire;
see ssi_jax/tokenizer/bpe_train.py.

Usage:
  python scripts/train_dsu_bpe.py out_dir --dataset <hf_or_json> --n-merges 4096 \\
      [--split train] [--speech-tokens-key speech_tokens] [--n-samples 100000]
"""

from argparse import ArgumentParser, Namespace
from itertools import groupby
import json
import logging
import os
from pathlib import Path
import sys

from ssi_jax.speech import SPEECH_TOKENS_KEY, dsu2pua
from ssi_jax.tokenizer.bpe_train import compression_ratio, save_ranks, train_bpe

logging.basicConfig(
    format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    level=os.environ.get("LOG_LEVEL", "INFO").upper(),
    stream=sys.stdout,
    force=True,
)

LOGGER = logging.getLogger(__name__)


def parse_args() -> Namespace:
    parser = ArgumentParser(description="Train BPE merges over DSU sequences.")
    parser.add_argument("output_dir", type=Path, help="Directory for tokenizer.model + stats.json.")
    parser.add_argument("--dataset", type=str, required=True, help="HF dataset path/name or local json file.")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--data-files", type=str, default=None, help="data_files for json/csv sources.")
    parser.add_argument("--n-merges", type=int, default=4096, help="Number of merges to learn.")
    parser.add_argument("--n-samples", type=int, default=None, help="Cap on corpus rows (streamed).")
    parser.add_argument("--speech-tokens-key", type=str, default=SPEECH_TOKENS_KEY)
    parser.add_argument("--min-pair-count", type=int, default=2)
    parser.add_argument(
        "--deduplicate",
        action="store_true",
        help="Collapse consecutive duplicate DSUs before training, matching the data "
        "pipeline's `speech.deduplicate` (default true there). Merges trained on raw "
        "streams mostly capture hold-repeats that deduplication removes at training "
        "time, so they never fire — set this whenever the consuming run deduplicates.",
    )
    return parser.parse_args()


def dsu_corpus(args: Namespace) -> list[str]:
    from ssi_jax.data import load_hf_dataset

    kwargs = {"split": args.split, "streaming": True}
    if args.data_files:
        kwargs["data_files"] = args.data_files
    ds = load_hf_dataset(args.dataset, **kwargs)
    corpus: list[str] = []
    for i, row in enumerate(ds):
        if args.n_samples is not None and i >= args.n_samples:
            break
        toks = row[args.speech_tokens_key]
        if isinstance(toks, str):
            toks = [int(t) for t in toks.split()]
        if args.deduplicate:
            toks = [k for k, _ in groupby(toks)]
        corpus.append("".join(dsu2pua(int(t)) for t in toks))
    if not corpus:
        raise ValueError(f"No rows with key {args.speech_tokens_key!r} in {args.dataset}:{args.split}")
    return corpus


def main(args: Namespace) -> None:
    args.output_dir.mkdir(parents=True, exist_ok=True)
    out_model = args.output_dir / "tokenizer.model"
    if out_model.exists():
        raise FileExistsError(f"Output merges file already exists: {out_model}")

    corpus = dsu_corpus(args)
    n_dsu_tokens = sum(len(c) for c in corpus)
    LOGGER.info(f"Training {args.n_merges} merges over {len(corpus)} rows / {n_dsu_tokens} DSUs")
    ranks = train_bpe(corpus, args.n_merges, split_pattern=None, min_pair_count=args.min_pair_count)
    save_ranks(ranks, out_model)
    ratio = compression_ratio(corpus, ranks)
    stats = {
        "n_rows": len(corpus),
        "deduplicate": args.deduplicate,
        "n_dsu_tokens": n_dsu_tokens,
        "n_merges_learned": len(ranks) - 256,
        "vocab_size": len(ranks),
        "compression_ratio_chars_per_token": round(ratio, 4),
    }
    (args.output_dir / "stats.json").write_text(json.dumps(stats, indent=2))
    LOGGER.info(f"Wrote {out_model} ({len(ranks)} ranks); compression {ratio:.3f} chars/token")


if __name__ == "__main__":
    main(parse_args())
