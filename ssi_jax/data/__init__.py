"""Host-side data pipeline: loading, sharding, sampling, fixed-shape collation.

JAX rebuild of the reference data setup (ref: ssi/data/__init__.py:30-232). The
load-bearing difference is **static shapes**: the reference pads each batch to the
batch max length (fine under CUDA eager; a recompile storm under XLA), while this
pipeline pads every batch to a fixed length — either the configured ``max_seq_len``
(default, a single compiled shape) or the smallest multiple-of-128 bucket that fits
the batch (bounded recompile count, less padding compute). Loss semantics are
padding-invariant because normalization counts only non-ignored label tokens
(ref: ssi/trainer.py:391-404).

``Sampler`` replaces ``torch.utils.data.DistributedSampler``: deterministic
epoch-seeded shuffling plus per-process index sharding for data-parallel hosts
(shards by ``jax.process_index()``-style rank; ref: ssi/data/__init__.py:83,120).
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from functools import partial
import logging
import math
from typing import Any

import numpy as np

from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX, SEED
from ssi_jax.utils import round_up as _round_up
from ssi_jax.data.cpt import TextCompletionDataset
from ssi_jax.data.sft import SFTDataset
from ssi_jax.tokenizer import Llama3Tokenizer

LOGGER = logging.getLogger(__name__)

__all__ = [
    "Loader",
    "Sampler",
    "load_dataset_subset",
    "load_hf_dataset",
    "padded_collate_sft",
    "setup_sft_data",
    "setup_text_completion_data",
]


def load_hf_dataset(source: str, **load_dataset_kwargs):
    """Load a full HF dataset split (non-streaming)."""
    import datasets as hf_datasets

    return hf_datasets.load_dataset(source, **load_dataset_kwargs)


def load_dataset_subset(source: str, n_samples: int, filter_fn=None, **load_dataset_kwargs):
    """Load the first ``n_samples`` rows of an HF dataset via streaming.

    Streams so only the requested rows transit the network (ref:
    ssi/data/__init__.py:30-56). ``filter_fn`` is applied to the STREAM before
    the take, so the result is "the first n_samples MATCHING rows" — filtering
    after the take would silently return fewer samples than requested.
    """
    import datasets as hf_datasets

    if "split" not in load_dataset_kwargs:
        raise ValueError("load_dataset_subset requires a 'split' kwarg (e.g. split='train')")
    iterable = hf_datasets.load_dataset(source, streaming=True, **load_dataset_kwargs)
    if filter_fn is not None:
        iterable = iterable.filter(filter_fn)
    rows = list(iterable.take(n_samples))
    LOGGER.info(
        f"Streamed {len(rows)}/{n_samples} samples from {source} (split={load_dataset_kwargs.get('split', '?')})"
    )
    return hf_datasets.Dataset.from_list(rows)


# --------------------------------------------------------------------------------
# Sampler: deterministic shuffle + per-process sharding
# --------------------------------------------------------------------------------


class Sampler:
    """Deterministic, shardable index sampler (DistributedSampler-equivalent).

    Pads the index list by wrapping so every rank yields the same count, shuffles
    with ``np.random.default_rng(seed + epoch)`` when requested, and yields the
    rank's strided slice. ``set_epoch`` reshuffles deterministically per epoch
    (ref: torch DistributedSampler semantics used at ssi/data/__init__.py:83).
    """

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = SEED,
        drop_last: bool = False,
    ) -> None:
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank ({rank}) must be in [0, num_replicas={num_replicas})")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding > 0:
                indices += (indices * math.ceil(padding / max(len(indices), 1)))[:padding]
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size
        return iter(indices[self.rank : self.total_size : self.num_replicas])


# --------------------------------------------------------------------------------
# Fixed-shape collation
# --------------------------------------------------------------------------------


def padded_collate_sft(
    batch: list[dict[str, Any]],
    padding_idx: int = 0,
    ignore_idx: int = CROSS_ENTROPY_IGNORE_IDX,
    additional_keys: list[str] | None = None,
    *,
    pad_to: int | None = None,
    bucket_multiple: int | None = None,
) -> dict[str, Any]:
    """Pad token/label lists into int32 arrays of a static sequence length.

    Behavioural superset of the reference collate (ref: ssi/data/__init__.py:139-199):
    tokens pad with ``padding_idx``, labels with ``ignore_idx``, ``additional_keys``
    pass through as lists. Shapes are static for XLA:

    - ``pad_to`` set: always pad to exactly ``pad_to`` (one compiled shape);
    - else ``bucket_multiple`` set: pad to the smallest multiple that fits;
    - else: pad to the batch max (reference behaviour; CPU/debug only).
    """
    if additional_keys is None:
        additional_keys = []
    batch_max = max(len(x["tokens"]) for x in batch)
    batch_max = max(batch_max, max(len(x["labels"]) for x in batch))
    if pad_to is not None:
        if batch_max > pad_to:
            raise ValueError(f"Sequence of length {batch_max} exceeds collate pad_to={pad_to}")
        seq_len = pad_to
    elif bucket_multiple is not None:
        seq_len = _round_up(batch_max, bucket_multiple)
    else:
        seq_len = batch_max

    n = len(batch)
    tokens = np.full((n, seq_len), padding_idx, dtype=np.int32)
    labels = np.full((n, seq_len), ignore_idx, dtype=np.int32)
    for i, x in enumerate(batch):
        tokens[i, : len(x["tokens"])] = x["tokens"]
        labels[i, : len(x["labels"])] = x["labels"]

    additional_keys_dict = {key: [x[key] for x in batch] for key in additional_keys}
    return {"tokens": tokens, "labels": labels} | additional_keys_dict


# --------------------------------------------------------------------------------
# Loader: host iterator yielding collated numpy batches
# --------------------------------------------------------------------------------


class Loader:
    """Minimal deterministic DataLoader: sampler -> dataset rows -> collate.

    Single-process by design — the reference also runs ``num_workers: 0``
    (conf/data/_cpt_base.yaml:25); host tokenization overlaps device compute
    naturally because JAX dispatch is async.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        sampler: Sampler,
        collate_fn: Callable[[list[dict[str, Any]]], dict[str, Any]],
        drop_last: bool = True,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        buf: list[dict[str, Any]] = []
        for idx in self.sampler:
            buf.append(self.dataset[idx])
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


# --------------------------------------------------------------------------------
# Setup entry points (ref: ssi/data/__init__.py:59-131)
# --------------------------------------------------------------------------------


def _collate_for(cfg_dataset: Any, model_tokenizer: Llama3Tokenizer) -> Callable:
    dataloader_cfg = cfg_dataset.dataloader
    pad_mode = dataloader_cfg.get("pad_mode", "max_seq_len")
    pad_to = None
    bucket_multiple = None
    if pad_mode == "max_seq_len":
        if model_tokenizer.max_seq_len is None:
            raise ValueError("pad_mode=max_seq_len requires tokenizer.max_seq_len to be set")
        pad_to = int(model_tokenizer.max_seq_len)
    elif pad_mode == "bucket":
        bucket_multiple = int(dataloader_cfg.get("bucket_multiple", 128))
    elif pad_mode != "batch_max":
        raise ValueError(f"Unknown pad_mode: {pad_mode!r} (expected max_seq_len | bucket | batch_max)")
    return partial(
        padded_collate_sft,
        padding_idx=model_tokenizer.pad_id,
        ignore_idx=CROSS_ENTROPY_IGNORE_IDX,
        additional_keys=list(cfg_dataset.dataset.get("additional_keys", []) or []),
        pad_to=pad_to,
        bucket_multiple=bucket_multiple,
    )


def _build_loader(
    dataset: Any,
    cfg_dataset: Any,
    model_tokenizer: Llama3Tokenizer,
    num_replicas: int,
    rank: int,
) -> tuple[Loader, Sampler]:
    sampler_shuffle = bool(cfg_dataset["shuffle"])
    if cfg_dataset.get("packed", False):
        # extension: the reference declares but never implements packing
        # (ref: ssi/data/__init__.py:69,106). Packs are fixed-shape by construction.
        from ssi_jax.data.packing import PackedDataset, WindowedPackedDataset, padded_collate_packed

        if model_tokenizer.max_seq_len is None:
            raise ValueError("PackedDataset requires a max_seq_len to be set on the tokenizer.")
        pack_window = cfg_dataset.get("pack_window")
        if pack_window:
            # Streaming-scale path: O(window) memory; the shuffle moves INTO the
            # dataset (hierarchical window/pack permutation) so index access
            # stays window-local — the sampler must iterate sequentially.
            dataset = WindowedPackedDataset(
                dataset,
                max_seq_len=int(model_tokenizer.max_seq_len),
                pad_id=model_tokenizer.pad_id,
                window=int(pack_window),
                split_across_pack=bool(cfg_dataset.get("split_across_pack", False)),
                shuffle=sampler_shuffle,
                seed=SEED,
            )
            sampler_shuffle = False
        else:
            dataset = PackedDataset(
                dataset,
                max_seq_len=int(model_tokenizer.max_seq_len),
                pad_id=model_tokenizer.pad_id,
                split_across_pack=bool(cfg_dataset.get("split_across_pack", False)),
            )
        collate_fn = padded_collate_packed
    else:
        collate_fn = _collate_for(cfg_dataset, model_tokenizer)
    sampler = Sampler(
        dataset_len=len(dataset),
        num_replicas=num_replicas,
        rank=rank,
        shuffle=sampler_shuffle,
        seed=SEED,
    )
    loader = Loader(
        dataset=dataset,
        batch_size=int(cfg_dataset.dataloader.batch_size),
        sampler=sampler,
        collate_fn=collate_fn,
        drop_last=bool(cfg_dataset.dataloader.get("drop_last", True)),
    )
    return loader, sampler


def _as_kwargs(node: Any) -> dict[str, Any]:
    """Materialize a config node into plain-python kwargs."""
    from ssi_jax.config import to_container

    out = to_container(node, resolve=True)
    if not isinstance(out, dict):
        raise TypeError(f"Expected a mapping config node, got {type(out)}")
    return out


def setup_text_completion_data(
    cfg_dataset: Any,
    model_tokenizer: Llama3Tokenizer,
    num_replicas: int = 1,
    rank: int = 0,
) -> tuple[Loader, Sampler]:
    """Build the CPT loader (ref: ssi/data/__init__.py:59-95)."""
    kwargs = _as_kwargs(cfg_dataset.dataset)
    dataset = TextCompletionDataset(tokenizer=model_tokenizer, **kwargs)
    loader, sampler = _build_loader(dataset, cfg_dataset, model_tokenizer, num_replicas, rank)
    LOGGER.info(f"Dataset and Sampler initialized from {cfg_dataset.dataset.source}.")
    return loader, sampler


def setup_sft_data(
    cfg_dataset: Any,
    model_tokenizer: Llama3Tokenizer,
    num_replicas: int = 1,
    rank: int = 0,
) -> tuple[Loader, Sampler]:
    """Build the SFT loader (ref: ssi/data/__init__.py:98-131)."""
    kwargs = _as_kwargs(cfg_dataset.dataset)
    dataset = SFTDataset(model_tokenizer=model_tokenizer, **kwargs)
    loader, sampler = _build_loader(dataset, cfg_dataset, model_tokenizer, num_replicas, rank)
    LOGGER.info(f"Dataset and Sampler initialized from {cfg_dataset.dataset.source}.")
    return loader, sampler


####################################################################################################
# Debug: Alpaca text-SFT loader (ref: ssi/data/__init__.py:213-231 — used to
# demonstrate OOM behavior during SFT; torchtune's alpaca_dataset equivalent)
####################################################################################################


class _AlpacaDataset:
    """Alpaca instruction rows -> masked SFT samples (torchtune alpaca_dataset
    semantics: train_on_input=True, instruction+input form the user turn)."""

    _PROMPT_WITH_INPUT = (
        "Below is an instruction that describes a task, paired with an input that provides "
        "further context. Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n### Response:\n"
    )
    _PROMPT_NO_INPUT = (
        "Below is an instruction that describes a task. Write a response that appropriately "
        "completes the request.\n\n### Instruction:\n{instruction}\n\n### Response:\n"
    )

    def __init__(self, tokenizer: Llama3Tokenizer, source: str = "tatsu-lab/alpaca",
                 train_on_input: bool = True, **load_dataset_kwargs) -> None:
        from ssi_jax.tokenizer.messages import Message

        self._tokenizer = tokenizer
        self._data = load_hf_dataset(source, split=load_dataset_kwargs.pop("split", "train"), **load_dataset_kwargs)
        self._train_on_input = train_on_input
        self._Message = Message

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> dict[str, Any]:
        row = self._data[int(index)]
        template = self._PROMPT_WITH_INPUT if row.get("input") else self._PROMPT_NO_INPUT
        user = template.format(instruction=row["instruction"], input=row.get("input", ""))
        messages = [
            self._Message(role="user", content=user, masked=not self._train_on_input, eot=True),
            self._Message(role="assistant", content=row["output"], masked=False, eot=True),
        ]
        tok = self._tokenizer({"messages": messages}, inference=False)
        tok["labels"] = list(np.where(tok["mask"], CROSS_ENTROPY_IGNORE_IDX, tok["tokens"]))
        return tok


def setup_alpaca_data(
    tokenizer: Llama3Tokenizer,
    batch_size: int,
    shuffle: bool = True,
    num_replicas: int = 1,
    rank: int = 0,
    source: str = "tatsu-lab/alpaca",
    **load_dataset_kwargs,
) -> tuple[Loader, Sampler]:
    """Debug SFT loader over the Alpaca dataset (ref: ssi/data/__init__.py:213-231).

    Kept for parity with the reference's OOM-debug workflow; unlike the reference
    it emits fixed-shape batches (pad_to=max_seq_len) so it is jit-friendly.
    """
    ds = _AlpacaDataset(tokenizer, source=source, **load_dataset_kwargs)
    sampler = Sampler(len(ds), num_replicas=num_replicas, rank=rank, shuffle=shuffle, seed=SEED, drop_last=True)
    collate = partial(
        padded_collate_sft,
        padding_idx=tokenizer.pad_id,
        ignore_idx=CROSS_ENTROPY_IGNORE_IDX,
        pad_to=tokenizer.max_seq_len,
    )
    loader = Loader(ds, sampler=sampler, batch_size=batch_size, collate_fn=collate, drop_last=True)
    LOGGER.info(f"Alpaca debug dataset and Sampler initialized from {source}.")
    return loader, sampler
