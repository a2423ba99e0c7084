"""Per-sample deterministic RNG properties of the CPT dataset.

Port of the reference property suite (ref: tests/test_cpt_deterministic_rng.py:38-106):
reproducibility, index/epoch sensitivity, order independence, span invariants.
"""

import numpy as np
import pytest

from ssi_jax.data.cpt import CompletionSequenceType, TextCompletionDataset, get_span_idxs_binomial, interleave
from ssi_jax.speech import (
    ALIGNMENT_END_TIME_KEY,
    ALIGNMENT_START_TIME_KEY,
    SPEECH_TOKENS_KEY,
    TOKENIZED_KEY,
)
from ssi_jax.tokenizer import setup_llama3_tokenizer
from tests import helpers

KEYS = {
    "tokenized": TOKENIZED_KEY,
    "t_starts": ALIGNMENT_START_TIME_KEY,
    "t_ends": ALIGNMENT_END_TIME_KEY,
    "speech_tokens": SPEECH_TOKENS_KEY,
}

INTERLEAVE_KW = dict(sampling_rate=16000, downsampling_ratio=320, mean_seq_len_tokens=10.0, binom_prob=0.1, keys=KEYS)


@pytest.fixture()
def dataset(tiny_extended_tokenizer_path, synthetic_data):
    tokenizer, _ = setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=256, verbose=False)
    return TextCompletionDataset(
        tokenizer=tokenizer,
        source="synthetic/cpt",
        split="train",
        sequence_type="interleaved",
        deduplicate=True,
        use_modality_tokens=True,
        interleave_kwargs={k: v for k, v in INTERLEAVE_KW.items() if k != "keys"},
    )


def test_reproducible_same_index(dataset):
    assert dataset[3] == dataset[3]


def test_index_sensitivity(dataset):
    assert dataset[3] != dataset[4]


def test_epoch_sensitivity(dataset):
    s0 = dataset[3]
    dataset.set_epoch(1)
    s1 = dataset[3]
    assert s0 != s1


def test_order_independence(dataset):
    """Sample i is identical whether accessed first, last, or alone
    (the property that makes resume skip-ahead exact)."""
    forward = [dataset[i] for i in range(8)]
    backward = [dataset[i] for i in reversed(range(8))][::-1]
    assert forward == backward
    assert dataset[5] == forward[5]


def test_span_idxs_invariants():
    rng = np.random.default_rng(0)
    for seq_len in [1, 2, 5, 50, 500]:
        idxs = get_span_idxs_binomial(10, 0.1, seq_len, rng)
        assert idxs[0] == 0
        assert idxs[-1] == seq_len
        assert all(b > a for a, b in zip(idxs, idxs[1:]))  # strictly increasing


def test_interleave_deterministic_given_rng():
    rows = helpers.synthetic_cpt_rows(1)
    out1 = interleave(rows[0], True, True, rng=np.random.default_rng((1, 0, 0)), **INTERLEAVE_KW)
    out2 = interleave(rows[0], True, True, rng=np.random.default_rng((1, 0, 0)), **INTERLEAVE_KW)
    assert out1 == out2
    out3 = interleave(rows[0], True, True, rng=np.random.default_rng((1, 0, 1)), **INTERLEAVE_KW)
    assert out1 != out3


def _make_ds(tokenizer_path, seq_type, use_modality_tokens=False):
    tokenizer, _ = setup_llama3_tokenizer(tokenizer_path, max_seq_len=256, verbose=False)
    return TextCompletionDataset(
        tokenizer=tokenizer,
        source="synthetic/cpt",
        split="train",
        sequence_type=seq_type,
        deduplicate=True,
        use_modality_tokens=use_modality_tokens,
    )


def test_all_declared_sequence_types_usable(tiny_extended_tokenizer_path, synthetic_data):
    """All six enum values construct; the reference left
    dsu_only/text_only/alternating declared-unimplemented (ref: ssi/data/cpt.py:36-38)."""
    for seq_type in CompletionSequenceType:
        if seq_type is CompletionSequenceType.INTERLEAVED:
            continue  # needs interleave_kwargs; covered by the main fixture
        ds = _make_ds(tiny_extended_tokenizer_path, seq_type.value)
        row = ds[0]
        assert len(row["tokens"]) > 1 and row["tokens"] == row["labels"]


def test_single_modality_content(tiny_extended_tokenizer_path, synthetic_data):
    """dsu_only rows carry only PUA speech tokens; text_only rows carry none."""

    def is_pua(tid, tokenizer):
        text = tokenizer.decode([tid], skip_special_tokens=False)
        return len(text) == 1 and 0xE000 <= ord(text) <= 0xF8FF

    dsu_ds = _make_ds(tiny_extended_tokenizer_path, "dsu_only")
    txt_ds = _make_ds(tiny_extended_tokenizer_path, "text_only")
    tok = dsu_ds._tokenizer
    specials = {tok.bos_id, tok.eos_id}
    dsu_body = [t for t in dsu_ds[0]["tokens"] if t not in specials]
    txt_body = [t for t in txt_ds[0]["tokens"] if t not in specials]
    assert dsu_body and all(is_pua(t, tok) for t in dsu_body)
    assert txt_body and not any(is_pua(t, tok) for t in txt_body)


def test_alternating_rng_discipline(tiny_extended_tokenizer_path, synthetic_data):
    """alternating picks text vs DSU per sample via the (seed, epoch, index)
    RNG: reproducible, order-independent, epoch-sensitive, and actually mixes."""
    ds = _make_ds(tiny_extended_tokenizer_path, "alternating")
    n = min(16, len(ds))
    forward = [ds[i] for i in range(n)]
    backward = [ds[i] for i in reversed(range(n))][::-1]
    assert forward == backward  # order independence
    assert forward == [ds[i] for i in range(n)]  # reproducible

    txt_ds = _make_ds(tiny_extended_tokenizer_path, "text_only")
    dsu_ds = _make_ds(tiny_extended_tokenizer_path, "dsu_only")
    kinds = set()
    for i in range(n):
        if forward[i] == txt_ds[i]:
            kinds.add("text")
        elif forward[i] == dsu_ds[i]:
            kinds.add("dsu")
        else:
            raise AssertionError(f"sample {i} matches neither single-modality form")
    assert kinds == {"text", "dsu"}  # both modalities drawn across 16 samples

    ds.set_epoch(1)
    epoch1 = [ds[i] for i in range(n)]
    assert epoch1 != forward  # epoch reseeds the draw
