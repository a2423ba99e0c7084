"""Packed-dataset tests: layout invariants, loss equivalence, trainer integration.

Packing is an extension the reference only planned
(ref: plans/Feature - Packed Dataset Support.md; ssi/data/__init__.py:69,106).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_jax.data.packing import PackedDataset, padded_collate_packed
from tests import helpers

PAD = 99


class ListDataset:
    def __init__(self, rows):
        self.rows = rows
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def make_rows(lengths, base=1):
    rows = []
    t = base
    for n in lengths:
        toks = list(range(t, t + n))
        rows.append({"tokens": toks, "labels": list(toks)})
        t += n
    return rows


def test_pack_layout_invariants():
    ds = PackedDataset(ListDataset(make_rows([5, 7, 4, 10, 3])), max_seq_len=16, pad_id=PAD)
    total_tokens = 5 + 7 + 4 + 10 + 3
    packed_tokens = 0
    for i in range(len(ds)):
        pack = ds[i]
        assert pack["tokens"].shape == (16,)
        real = pack["segment_ids"] > 0
        packed_tokens += int(real.sum())
        # padding is pad_id / ignore / 0
        assert (pack["tokens"][~real] == PAD).all()
        assert (pack["labels"][~real] == CROSS_ENTROPY_IGNORE_IDX).all()
        assert (pack["positions"][~real] == 0).all()
        # positions restart at 0 within each segment and increase by 1
        for seg in np.unique(pack["segment_ids"][real]):
            seg_pos = pack["positions"][pack["segment_ids"] == seg]
            np.testing.assert_array_equal(seg_pos, np.arange(len(seg_pos)))
        # segment ids are 1..k contiguous
        segs = np.unique(pack["segment_ids"][real])
        np.testing.assert_array_equal(segs, np.arange(1, len(segs) + 1))
    assert packed_tokens == total_tokens  # nothing lost, nothing duplicated


def test_split_across_pack():
    ds = PackedDataset(
        ListDataset(make_rows([10, 10, 10])), max_seq_len=16, pad_id=PAD, split_across_pack=True
    )
    # splitting -> zero padding except the final pack
    for i in range(len(ds) - 1):
        assert (ds[i]["segment_ids"] > 0).all()
    total = sum((ds[i]["segment_ids"] > 0).sum() for i in range(len(ds)))
    assert total == 30


def test_oversized_sample_dropped_or_raises():
    rows = make_rows([5, 30, 4])
    ds = PackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, drop_long=True)
    packed = sum(int((ds[i]["segment_ids"] > 0).sum()) for i in range(len(ds)))
    assert packed == 9  # the 30-token sample dropped
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        PackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, drop_long=False)


def test_packed_loss_equals_unpacked_sum():
    """Sum-NLL over a pack == sum of per-sample NLLs computed separately."""
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.train.step import make_loss_fn

    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    loss_fn = make_loss_fn(cfg, attn_impl="xla", remat=False, chunk_size=64)

    rng = np.random.default_rng(0)
    lens = [9, 13, 6]
    rows = [
        {"tokens": rng.integers(0, cfg.vocab_size, n).tolist()} for n in lens
    ]
    for r in rows:
        r["labels"] = list(r["tokens"])

    ds = PackedDataset(ListDataset(rows), max_seq_len=32, pad_id=0)
    batch = padded_collate_packed([ds[i] for i in range(len(ds))])
    packed_loss, packed_ntok = loss_fn(
        params,
        jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"]),
        jnp.asarray(batch["segment_ids"]),
        jnp.asarray(batch["positions"]),
    )

    solo_loss = 0.0
    solo_ntok = 0
    for r in rows:
        ls, nt = loss_fn(params, jnp.asarray([r["tokens"]], jnp.int32), jnp.asarray([r["labels"]], jnp.int32))
        solo_loss += float(ls)
        solo_ntok += int(nt)

    assert int(packed_ntok) == solo_ntok  # boundary-masked shift drops exactly the cross-sample labels
    np.testing.assert_allclose(float(packed_loss), solo_loss, rtol=1e-5)


def test_repack_per_epoch_keeps_length():
    rows = make_rows([5, 7, 4, 10, 3])
    ds = PackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD)
    n0 = len(ds)
    ds.set_epoch(1)
    assert len(ds) == n0
    assert ds.dataset.epoch == 1


def test_packed_trainer_end_to_end(tmp_path, synthetic_data):
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="cpt")
    cfg_dict["data"]["train"]["packed"] = True
    cfg_dict["data"]["dev"]["packed"] = True
    cfg_dict["max_steps"] = 3
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    losses = []
    t._loss_log = losses
    t.train()
    dev = t._evaluate()
    t.cleanup()
    assert len(losses) == 3 and all(np.isfinite(x) for x in losses)
    assert np.isfinite(dev)


# ---------------------------------------------------------------------------
# WindowedPackedDataset (streaming-scale packing)
# ---------------------------------------------------------------------------

def test_windowed_matches_eager_when_window_covers_dataset():
    from ssi_jax.data.packing import WindowedPackedDataset

    rows = make_rows([5, 7, 4, 10, 3, 6, 2, 8])
    eager = PackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD)
    windowed = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=100)
    assert len(windowed) == len(eager)
    for i in range(len(eager)):
        for k in ("tokens", "labels", "segment_ids", "positions"):
            np.testing.assert_array_equal(windowed[i][k], eager[i][k])


def test_windowed_o_window_memory_and_locality():
    from ssi_jax.data.packing import WindowedPackedDataset

    rows = make_rows([4] * 64)
    ds = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8)
    # 8 windows x (8 samples of 4 -> 2 packs of 16)
    assert ds.n_windows == 8 and ds.packs_per_window == 2 and len(ds) == 16
    for i in range(len(ds)):
        pack = ds[i]
        assert int((pack["segment_ids"] > 0).sum()) == 16
    assert len(ds._cache) <= ds._CACHE_WINDOWS  # never holds the whole epoch


def test_windowed_deterministic_and_epoch_sensitive_shuffle():
    from ssi_jax.data.packing import WindowedPackedDataset

    rows = make_rows([4] * 64)
    a = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8, shuffle=True, seed=7)
    b = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8, shuffle=True, seed=7)
    flat_a = [a[i]["tokens"].tolist() for i in range(len(a))]
    flat_b = [b[i]["tokens"].tolist() for i in range(len(b))]
    assert flat_a == flat_b  # deterministic across instances

    # shuffled order is a bijection over the eager pack set
    plain = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8)
    ordered = sorted([plain[i]["tokens"].tolist() for i in range(len(plain))])
    assert sorted(flat_a) == ordered

    a.set_epoch(1)
    flat_a1 = [a[i]["tokens"].tolist() for i in range(len(a))]
    assert flat_a1 != flat_a  # epoch reshuffles
    assert sorted(flat_a1) == ordered  # ... but the same multiset


def test_windowed_clamps_ragged_windows():
    from ssi_jax.data.packing import WindowedPackedDataset

    # windows pack to differing counts; all clamp/cycle to the calibration count
    rows = make_rows([10, 10, 3, 3, 3, 3, 14, 2])
    ds = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=4)
    assert len(ds) == ds.n_windows * ds.packs_per_window
    for i in range(len(ds)):
        assert int((ds[i]["segment_ids"] > 0).sum()) > 0


def test_windowed_partial_tail_is_prorated_not_inflated():
    """A final partial window must get a prorated pack quota: 65 samples at
    window=8 leaves a 1-sample tail, which must contribute ~1/8 of a window's
    packs (here 1), not be cycle-duplicated up to the full quota."""
    from ssi_jax.data.packing import WindowedPackedDataset

    rows = make_rows([4] * 65)
    ds = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8)
    assert ds.n_windows == 9 and ds.packs_per_window == 2
    assert ds.packs_tail == 1  # round(2 * 1/8) -> at least 1, not 2
    assert len(ds) == 8 * 2 + 1
    # the tail sample appears exactly once in the epoch
    tail_tok = rows[64]["tokens"]
    hits = sum(
        1 for i in range(len(ds))
        if any(
            ds[i]["tokens"][j : j + len(tail_tok)].tolist() == tail_tok
            and ds[i]["segment_ids"][j] > 0
            for j in range(ds[i]["tokens"].shape[0] - len(tail_tok) + 1)
        )
    )
    assert hits >= 1
    # shuffled epochs cover the same multiset, tail included exactly once
    sh = WindowedPackedDataset(ListDataset(rows), max_seq_len=16, pad_id=PAD, window=8, shuffle=True, seed=3)
    assert len(sh) == len(ds)
    assert sorted(sh[i]["tokens"].tolist() for i in range(len(sh))) == sorted(
        ds[i]["tokens"].tolist() for i in range(len(ds))
    )


def test_windowed_packed_trainer_end_to_end(tmp_path, synthetic_data):
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="cpt")
    cfg_dict["data"]["train"]["packed"] = True
    cfg_dict["data"]["train"]["pack_window"] = 8
    cfg_dict["data"]["dev"]["packed"] = True
    cfg_dict["data"]["dev"]["pack_window"] = 8
    cfg_dict["max_steps"] = 3
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    losses = []
    t._loss_log = losses
    t.train()
    dev = t._evaluate()
    t.cleanup()
    assert len(losses) == 3 and all(np.isfinite(x) for x in losses)
    assert np.isfinite(dev)
