"""Loader/collate coverage: pad modes, drop_last, additional keys, window stacking."""

import numpy as np
import pytest

from ssi_jax.data import Loader, Sampler, padded_collate_sft


def rows(lengths):
    return [{"tokens": list(range(1, n + 1)), "labels": list(range(1, n + 1))} for n in lengths]


def test_pad_mode_bucket_rounds_up():
    batch = rows([5, 130])
    out = padded_collate_sft(batch, padding_idx=0, bucket_multiple=128)
    assert out["tokens"].shape == (2, 256)  # 130 -> next multiple of 128
    assert out["tokens"][0, 5:].sum() == 0
    assert (out["labels"][0, 5:] == -100).all()


def test_pad_mode_batch_max():
    out = padded_collate_sft(rows([3, 7]), padding_idx=9)
    assert out["tokens"].shape == (2, 7)
    assert out["tokens"][0].tolist() == [1, 2, 3, 9, 9, 9, 9]


def test_additional_keys_pass_through():
    batch = [
        {"tokens": [1], "labels": [1], "ID": "a"},
        {"tokens": [2, 3], "labels": [2, 3], "ID": "b"},
    ]
    out = padded_collate_sft(batch, padding_idx=0, additional_keys=["ID"], pad_to=4)
    assert out["ID"] == ["a", "b"]
    assert out["tokens"].shape == (2, 4)


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"tokens": [i + 1] * (i % 3 + 1), "labels": [i + 1] * (i % 3 + 1)}


def test_loader_drop_last_semantics():
    ds = _DS(10)
    sampler = Sampler(10, shuffle=False)
    keep = Loader(ds, batch_size=3, sampler=sampler, collate_fn=lambda b: b, drop_last=False)
    drop = Loader(ds, batch_size=3, sampler=sampler, collate_fn=lambda b: b, drop_last=True)
    assert len(keep) == 4 and len(drop) == 3
    batches_keep = list(keep)
    batches_drop = list(drop)
    assert len(batches_keep) == 4 and len(batches_keep[-1]) == 1
    assert len(batches_drop) == 3 and all(len(b) == 3 for b in batches_drop)


def test_collate_rejects_oversize_for_pad_to():
    with pytest.raises(ValueError, match="exceeds"):
        padded_collate_sft(rows([10]), padding_idx=0, pad_to=8)


def test_sampler_epoch_determinism_with_loader():
    ds = _DS(12)
    sampler = Sampler(12, shuffle=True)
    loader = Loader(ds, batch_size=4, sampler=sampler, collate_fn=lambda b: [len(x["tokens"]) for x in b])
    sampler.set_epoch(0)
    a = list(loader)
    sampler.set_epoch(0)
    b = list(loader)
    sampler.set_epoch(1)
    c = list(loader)
    assert a == b
    assert a != c


def test_alpaca_debug_loader(tiny_tokenizer_path, monkeypatch):
    """Reference debug helper parity (ref: ssi/data/__init__.py:213-231)."""
    import datasets as hfd

    import ssi_jax.data as dm
    from ssi_jax.tokenizer import setup_llama3_tokenizer

    tiny_tokenizer, _ = setup_llama3_tokenizer(path=str(tiny_tokenizer_path), max_seq_len=128)

    rows = [
        {"instruction": f"Say {i}", "input": "" if i % 2 else "context", "output": f"answer {i}"}
        for i in range(8)
    ]
    monkeypatch.setattr(dm, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    loader, sampler = dm.setup_alpaca_data(tiny_tokenizer, batch_size=4)
    assert len(sampler) == 8
    batch = next(iter(loader))
    assert batch["tokens"].shape == (4, tiny_tokenizer.max_seq_len)
    assert batch["labels"].shape == batch["tokens"].shape
    # train_on_input=True: both user and assistant tokens contribute to loss
    assert (batch["labels"] != -100).sum() > 0


def test_cpt_additional_keys_flow_to_batches(synthetic_data, tiny_extended_tokenizer_path):
    """additional_keys on a CPT config must flow dataset -> collate -> batch
    (the reference DECLARES this on the CPT collate but its dataset crashes on
    the kwarg; previously our CPT popped the key but the collate still
    expected it -> KeyError at the first batch)."""
    from ssi_jax.config import Config
    from ssi_jax.data import setup_text_completion_data
    from ssi_jax.tokenizer import setup_llama3_tokenizer

    tok, _ = setup_llama3_tokenizer(path=str(tiny_extended_tokenizer_path), max_seq_len=64)
    cfg = Config(
        {
            "dataset": {
                "source": "synthetic/cpt",
                "split": "train",
                "sequence_type": "interleaved",
                "interleave_kwargs": {
                    "sampling_rate": 16000,
                    "downsampling_ratio": 320,
                    "mean_seq_len_tokens": 10.0,
                    "binom_prob": 0.1,
                },
                "deduplicate": True,
                "use_modality_tokens": True,
                "additional_keys": ["tokenized"],
                "n_samples": None,
            },
            "dataloader": {"batch_size": 2, "drop_last": True, "pad_mode": "max_seq_len"},
            "shuffle": False,
            "packed": False,
        }
    )
    loader, _sampler = setup_text_completion_data(cfg, tok)
    batch = next(iter(loader))
    assert "tokenized" in batch and len(batch["tokenized"]) == 2
    assert isinstance(batch["tokenized"][0], list)
