"""First-party BPE trainer — the missing half of the reference's DSU-compression axis.

The reference's experiment matrix is 4 speech tokenizers x 4 approaches x
**2 compression settings** ("using BPE to compress the speech tokens or not",
ref: plans/Checkpointing - Consolidated Plan.md:23,146-170), but no BPE trainer
exists anywhere in the reference — compressed runs were planned around
externally-produced merges. This module trains byte-level BPE merges in the
exact ``tokenizer.model`` format the (tiktoken/native) tokenizer stack loads,
so a compressed-DSU vocabulary plugs into the existing extend -> train -> \
generate pipeline unchanged.

Two modes, selected by ``split_pattern``:

- ``None`` (DSU compression): each corpus line is ONE piece, so merges freely
  span adjacent DSU codepoints — exactly what compression needs. NB the
  PUA-aware split pattern (CL100K_PATTERN_PUA) would defeat this by isolating
  every DSU character; a compressed-DSU tokenizer must therefore be loaded
  with a pattern that does not split \\p{Co} if merged-DSU tokens are to fire
  at encode time.
- a regex (text mode): pieces are the pattern's matches, reproducing standard
  GPT-style training semantics (merges never cross piece boundaries).

Training is the classic frequency-table algorithm with incremental pair-count
updates (only the counts touched by a merge are adjusted), so cost scales with
corpus *vocabulary*, not corpus length, per merge.
"""

from __future__ import annotations

import base64
from collections import Counter
from pathlib import Path
from typing import Iterable, Iterator


def _pieces(corpus: Iterable[str], split_pattern: str | None) -> Iterator[bytes]:
    if split_pattern is None:
        for line in corpus:
            if line:
                yield line.encode("utf-8")
        return
    import regex

    pat = regex.compile(split_pattern)
    for line in corpus:
        for m in pat.finditer(line):
            yield m.group().encode("utf-8")


def train_bpe(
    corpus: Iterable[str],
    n_merges: int,
    *,
    split_pattern: str | None = None,
    min_pair_count: int = 2,
) -> dict[bytes, int]:
    """Train byte-level BPE; returns mergeable ranks {token_bytes: rank}.

    Ranks 0..255 are the byte alphabet; learned merges follow in order. Stops
    early when no pair reaches ``min_pair_count``. Ties break lexicographically
    (deterministic for a fixed corpus).
    """
    ranks: dict[bytes, int] = {bytes([i]): i for i in range(256)}

    # word -> frequency, with each word as a tuple of current tokens
    words = Counter()
    for piece in _pieces(corpus, split_pattern):
        words[tuple(bytes([b]) for b in piece)] += 1
    words = dict(words)

    pair_counts: Counter = Counter()
    pair_words: dict[tuple[bytes, bytes], set] = {}
    for w, freq in words.items():
        for a, b in zip(w, w[1:]):
            pair_counts[(a, b)] += freq
            pair_words.setdefault((a, b), set()).add(w)

    for rank in range(256, 256 + n_merges):
        if not pair_counts:
            break
        (a, b), cnt = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < min_pair_count:
            break
        merged_tok = a + b
        ranks[merged_tok] = rank

        # rewrite only the words containing the merged pair
        affected = list(pair_words.pop((a, b), ()))
        pair_counts.pop((a, b), None)
        for w in affected:
            freq = words.pop(w, None)
            if freq is None:
                continue
            # remove old pair contributions
            for pa, pb in zip(w, w[1:]):
                pair_counts[(pa, pb)] -= freq
                if pair_counts[(pa, pb)] <= 0:
                    del pair_counts[(pa, pb)]
                ws = pair_words.get((pa, pb))
                if ws is not None:
                    ws.discard(w)
                    if not ws:
                        del pair_words[(pa, pb)]
            # apply the merge left-to-right
            new_w, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    new_w.append(merged_tok)
                    i += 2
                else:
                    new_w.append(w[i])
                    i += 1
            new_w = tuple(new_w)
            words[new_w] = words.get(new_w, 0) + freq
            for pa, pb in zip(new_w, new_w[1:]):
                pair_counts[(pa, pb)] += freq
                pair_words.setdefault((pa, pb), set()).add(new_w)

    return ranks


def save_ranks(ranks: dict[bytes, int], path: str | Path) -> None:
    """Write ranks in tokenizer.model format ("<base64> <rank>" lines)."""
    with open(path, "w") as f:
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok).decode() + f" {rank}\n")


def compression_ratio(corpus: Iterable[str], ranks: dict[bytes, int]) -> float:
    """Mean tokens-per-codepoint improvement: len(chars) / len(tokens) under a
    greedy whole-piece encoding with the trained ranks (no split pattern)."""
    import tiktoken

    enc = tiktoken.Encoding(
        name="trained", pat_str=r"(?s:.+)", mergeable_ranks=ranks, special_tokens={}
    )
    total_chars = total_tokens = 0
    for line in corpus:
        if not line:
            continue
        total_chars += len(line)
        total_tokens += len(enc.encode(line, allowed_special=set(), disallowed_special=()))
    return total_chars / max(1, total_tokens)


def merge_into_tokenizer(
    base_model: str | Path,
    trained_ranks: dict[bytes, int],
    output_path: str | Path,
    use_modality_tokens: bool = False,
) -> int:
    """Append trained DSU-compression merges to a base ``tokenizer.model``.

    Tokens with rank >= 256 in ``trained_ranks`` (the learned merges, which by
    BPE construction include every intermediate needed to assemble them) are
    appended after the base vocabulary with consecutive ranks, mirroring the
    PUA append of ``ssi_jax.extend.extend_tiktoken`` but for *merged* DSU
    sequences. The resulting file is the ``tokenizer.model`` of a compressed
    run; load it with ``pattern=CL100K_PATTERN`` (see Llama3Tokenizer) so the
    merges fire, and extend the model embedding by the RETURNED count
    (pass it as ``n_dsus``).

    ``use_modality_tokens``: also append the two modality tokens after the
    merges, matching ``extend_tiktoken``'s [dsu | modality] layout. Required
    when this file substitutes the tokenizer of a model extended with
    ``speech.use_modality_tokens`` (the default) — without them the specials
    land two ranks below the extended ``config.json``'s bos/eos ids and the
    modality codepoints fall back to raw UTF-8 bytes. Modality tokens do NOT
    count toward the returned ``n_dsus`` (the embedding layout accounts for
    them separately, exactly as in the uncompressed path).

    Returns the number of appended compression tokens (single-DSU + merges).
    """
    import base64 as b64

    base_model = Path(base_model)
    output_path = Path(output_path)
    if output_path.exists():
        raise FileExistsError(f"Extended tokenizer output already exists at: {output_path}")
    lines = base_model.read_text().splitlines()
    existing = {b64.b64decode(line.split()[0]) for line in lines if line}
    next_rank = 1 + max(int(line.split()[1]) for line in lines if line)

    new_tokens = [tok for tok, r in sorted(trained_ranks.items(), key=lambda kv: kv[1]) if r >= 256]
    appended = 0
    with open(output_path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for tok in new_tokens:
            if tok in existing:
                continue  # byte alphabet / overlap with base vocab
            f.write(b64.b64encode(tok).decode() + f" {next_rank}\n")
            next_rank += 1
            appended += 1
        if use_modality_tokens:
            from ssi_jax.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT

            for tok_str in (MODALITY_TOKEN_TEXT, MODALITY_TOKEN_SPEECH):
                tok = tok_str.encode("utf-8")
                if tok in existing:
                    raise RuntimeError(f"Modality token {tok_str!r} already exists in the base vocabulary")
                f.write(b64.b64encode(tok).decode() + f" {next_rank}\n")
                next_rank += 1
    return appended
