"""Resume equivalence — the crown jewel (ref: tests/test_resume_equivalence.py:1-354).

A full N-step run and an interrupted run (N/2 steps -> save -> fresh Trainer resumed
from the training state) must produce **bitwise-identical** per-step losses and
identical non-timing metrics. fp32 on CPU; XLA reductions are deterministic for a
fixed program, so exact float equality is the contract, as in the reference.
"""

import numpy as np
import pytest

from tests import helpers

TOTAL_STEPS = 8
HALF_STEPS = 4

TIMING_KEYS = {"duration_step", "tokens_per_second_per_gpu", "train_clock_time"}


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def run_trainer(model_dir, ckpt_dir, max_steps, training_state=None, save_steps=HALF_STEPS, mesh=None, extra_cfg=None):
    from ssi_jax.train import Trainer

    cfg_dict = helpers.base_train_cfg_dict(model_dir, ckpt_dir, kind="sft")
    cfg_dict["max_steps"] = max_steps
    cfg_dict["save_steps"] = save_steps
    cfg_dict["eval_steps"] = save_steps
    if mesh is not None:
        cfg_dict["parallel"] = {"dp": mesh[0], "tp": mesh[1]}
    if extra_cfg:
        _deep_merge(cfg_dict, extra_cfg)
    # Constant LR: a cosine schedule depends on max_steps, which differs between the
    # full and interrupted runs (same choice as ref: tests/test_resume_equivalence.py:128).
    cfg_dict["lr_scheduler"] = None
    if training_state is not None:
        cfg_dict["checkpointer"]["training_state_checkpoint"] = str(training_state)
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    losses = []
    t._loss_log = losses
    t.train()
    history = list(t.metric_logger.history)
    t.cleanup()
    return t, losses, history


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return helpers.make_tiny_hf_checkpoint(tmp_path_factory.mktemp("model") / "m")


def _patch_data(monkeypatch):
    import datasets as hfd

    import ssi_jax.data as data_mod

    sft_rows = helpers.synthetic_sft_rows(64)
    monkeypatch.setattr(data_mod, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(sft_rows))


def test_resume_equivalence_bitwise(model_dir, tmp_path, monkeypatch):
    _patch_data(monkeypatch)

    # Full uninterrupted run
    _, losses_full, history_full = run_trainer(model_dir, tmp_path / "full", TOTAL_STEPS)
    assert len(losses_full) == TOTAL_STEPS

    # Interrupted run: first half...
    _, losses_a, history_a = run_trainer(model_dir, tmp_path / "int", HALF_STEPS)
    assert len(losses_a) == HALF_STEPS
    state_path = tmp_path / "int" / "training_state.msgpack"
    assert state_path.is_file()

    # ...then resume from step_4 weights + training state.
    t2, losses_b, history_b = run_trainer(
        model_dir=tmp_path / "int" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "resumed",
        max_steps=TOTAL_STEPS,
        training_state=state_path,
    )
    assert t2.global_step == TOTAL_STEPS
    assert len(losses_b) == TOTAL_STEPS - HALF_STEPS

    # Exact float equality of the per-step loss stream (ref: :292-297)
    combined = losses_a + losses_b
    assert combined == losses_full, (
        f"Loss streams diverge:\nfull    ={losses_full}\ncombined={combined}"
    )

    # All non-timing metrics identical (ref: :349-354)
    merged = {r["step"]: r for r in history_a + history_b}
    for rec in history_full:
        res = merged[rec["step"]]
        for k, v in rec.items():
            if k in TIMING_KEYS:
                continue
            assert res[k] == v, f"metric {k} diverges at step {rec['step']}: {res[k]} != {v}"


def test_resume_equivalence_overlap_io(model_dir, tmp_path, monkeypatch):
    """The pipelined input loop (overlap_io: one window in flight, metrics
    synced one step late) must keep the bitwise resume contract: save steps
    fall back to a synchronous step, so the checkpoint state and the resume
    position are exactly the synchronous loop's."""
    _patch_data(monkeypatch)
    ovl = {"overlap_io": True}

    _, losses_full, _ = run_trainer(model_dir, tmp_path / "full", TOTAL_STEPS, extra_cfg=ovl)
    _, losses_a, _ = run_trainer(model_dir, tmp_path / "int", HALF_STEPS, extra_cfg=ovl)
    t2, losses_b, _ = run_trainer(
        model_dir=tmp_path / "int" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "resumed",
        max_steps=TOTAL_STEPS,
        training_state=tmp_path / "int" / "training_state.msgpack",
        extra_cfg=ovl,
    )
    assert t2.global_step == TOTAL_STEPS
    assert losses_a + losses_b == losses_full


@pytest.mark.parametrize(
    "mesh_a,mesh_b",
    [
        ((2, 4), (1, 8)),  # save on dp2xtp4, resume on tp8 (batch_size=2 bounds dp)
        ((1, 8), (2, 4)),  # ...and the reverse
        ((1, 1), (2, 4)),  # tp=4 does not divide the tiny vocab (530) -> exercises the
        #                    _divisible_spec replication fallback with a RESTORED opt state
    ],
)
def test_resume_across_mesh_relayout(model_dir, tmp_path, monkeypatch, mesh_a, mesh_b):
    """Checkpoints are mesh-layout-free: save under one dp/tp factorization, resume
    under another, and the loss stream must continue like the uninterrupted run.

    Cross-layout SPMD partitioning changes reduction order, so the contract here is
    fp32-rounding agreement (same tolerance as tests/test_parallel.py), not the
    bitwise equality required on an identical topology.
    """
    _patch_data(monkeypatch)
    tag = f"{mesh_a[0]}x{mesh_a[1]}-{mesh_b[0]}x{mesh_b[1]}"

    _, losses_full, _ = run_trainer(model_dir, tmp_path / f"full{tag}", TOTAL_STEPS, mesh=mesh_a)

    _, losses_a, _ = run_trainer(model_dir, tmp_path / f"int{tag}", HALF_STEPS, mesh=mesh_a)
    t2, losses_b, _ = run_trainer(
        model_dir=tmp_path / f"int{tag}" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / f"res{tag}",
        max_steps=TOTAL_STEPS,
        training_state=tmp_path / f"int{tag}" / "training_state.msgpack",
        mesh=mesh_b,
    )
    assert t2.global_step == TOTAL_STEPS
    # first half ran on the same layout as the full run -> bitwise
    assert losses_a == losses_full[:HALF_STEPS]
    # second half ran on a different layout -> fp32-rounding agreement
    for got, want in zip(losses_b, losses_full[HALF_STEPS:]):
        assert got == pytest.approx(want, rel=1e-5), (losses_b, losses_full[HALF_STEPS:])


def test_resume_sharded_optimizer_state(model_dir, tmp_path, monkeypatch):
    """Orbax sharded optimizer state: bitwise resume on the same mesh, fp32
    agreement across a relayout, marker in msgpack, superseded dirs pruned."""
    pytest.importorskip("orbax.checkpoint")
    from ssi_jax.checkpoint import TRAINING_STATE_FNAME, unpack_state
    from ssi_jax.checkpoint.orbax_io import ORBAX_DIR_KEY
    from ssi_jax.constants import OPTIMIZER_KEY

    _patch_data(monkeypatch)
    sharded = {"sharded_optimizer_state": True}

    _, losses_full, _ = run_trainer(model_dir, tmp_path / "full", TOTAL_STEPS, mesh=(2, 4))

    # interrupted run saves at HALF and TOTAL -> the TOTAL save must prune HALF's dir
    _, losses_a, _ = run_trainer(
        model_dir, tmp_path / "int", HALF_STEPS, save_steps=HALF_STEPS // 2, mesh=(2, 4), extra_cfg=sharded
    )
    state_path = tmp_path / "int" / TRAINING_STATE_FNAME
    raw = unpack_state(state_path.read_bytes())
    opt_entry = raw[OPTIMIZER_KEY]
    assert isinstance(opt_entry, dict) and ORBAX_DIR_KEY in opt_entry
    assert (tmp_path / "int" / opt_entry[ORBAX_DIR_KEY]).is_dir()
    orbax_dirs = list((tmp_path / "int").glob("optimizer_state_orbax_step*"))
    assert len(orbax_dirs) == 1, orbax_dirs  # step_2's dir pruned by step_4's save

    # resume on a DIFFERENT mesh layout: orbax re-shards on read
    t2, losses_b, _ = run_trainer(
        model_dir=tmp_path / "int" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "res",
        max_steps=TOTAL_STEPS,
        training_state=state_path,
        mesh=(1, 8),
        extra_cfg=sharded,
    )
    assert t2.global_step == TOTAL_STEPS
    assert losses_a == losses_full[:HALF_STEPS]
    for got, want in zip(losses_b, losses_full[HALF_STEPS:]):
        assert got == pytest.approx(want, rel=1e-5), (losses_b, losses_full[HALF_STEPS:])


def test_resume_validates_hparams(model_dir, tmp_path, monkeypatch):
    """Changing batch geometry on resume must be refused (ref: ssi/train_utils.py:110-126)."""
    from ssi_jax.train import Trainer

    _patch_data(monkeypatch)
    run_trainer(model_dir, tmp_path / "a", HALF_STEPS)
    cfg_dict = helpers.base_train_cfg_dict(tmp_path / "a" / f"step_{HALF_STEPS}", tmp_path / "b", kind="sft")
    cfg_dict["checkpointer"]["training_state_checkpoint"] = str(tmp_path / "a" / "training_state.msgpack")
    cfg_dict["gradient_accumulation_steps"] = 4  # was 2
    cfg_dict["max_steps"] = TOTAL_STEPS
    t = Trainer(helpers.make_cfg(cfg_dict))
    with pytest.raises(ValueError, match="hparam mismatch"):
        t.setup()

    # force_resume downgrades to a warning
    cfg_dict["force_resume"] = True
    t2 = Trainer(helpers.make_cfg(cfg_dict))
    t2.setup()
    t2.cleanup()


def test_resume_consumed_samples_and_counters(model_dir, tmp_path, monkeypatch):
    _patch_data(monkeypatch)
    t1, _, _ = run_trainer(model_dir, tmp_path / "x", HALF_STEPS)
    t2, _, _ = run_trainer(
        model_dir=tmp_path / "x" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "y",
        max_steps=TOTAL_STEPS,
        training_state=tmp_path / "x" / "training_state.msgpack",
    )
    t_full, _, _ = run_trainer(model_dir, tmp_path / "z", TOTAL_STEPS)
    assert t2.consumed_samples == t_full.consumed_samples
    assert t2.tokens_train_total == t_full.tokens_train_total
    assert dict(t2.token_type_counts_total) == dict(t_full.token_type_counts_total)


def test_resume_across_epoch_boundary(model_dir, tmp_path, monkeypatch):
    """Interrupt in epoch 0, resume into epochs 1-2: epochs_run derivation, sampler
    reshuffle, and per-epoch dataset state must all line up bitwise."""
    import datasets as hfd

    import ssi_jax.data as data_mod

    # small dataset -> steps_per_epoch = 16 rows / batch 2 / accum 2 = 4
    rows = helpers.synthetic_sft_rows(16)
    monkeypatch.setattr(data_mod, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))

    total, save_at = 10, 4  # 10 steps = 2.5 epochs; save exactly at the epoch-0 end
    _, losses_full, _ = run_trainer(model_dir, tmp_path / "full", total, save_steps=2)
    assert len(losses_full) == total

    _, losses_a, _ = run_trainer(model_dir, tmp_path / "int", save_at, save_steps=2)
    t2, losses_b, _ = run_trainer(
        model_dir=tmp_path / "int" / f"step_{save_at}",
        ckpt_dir=tmp_path / "res",
        max_steps=total,
        training_state=tmp_path / "int" / "training_state.msgpack",
        save_steps=2,
    )
    assert t2.global_step == total
    assert losses_a + losses_b == losses_full

    # and a mid-epoch-1 interruption (step 6 = epoch 1, step 2 of 4)
    _, losses_c, _ = run_trainer(model_dir, tmp_path / "int6", 6, save_steps=2)
    t3, losses_d, _ = run_trainer(
        model_dir=tmp_path / "int6" / "step_6",
        ckpt_dir=tmp_path / "res6",
        max_steps=total,
        training_state=tmp_path / "int6" / "training_state.msgpack",
        save_steps=2,
    )
    assert losses_c + losses_d == losses_full


def test_resume_equivalence_windowed_packed(model_dir, tmp_path, monkeypatch):
    """Bitwise resume with the streaming windowed packer:
    pack content is a pure function of (epoch, window), so no packer state is
    checkpointed and the loss stream must continue exactly."""
    _patch_data(monkeypatch)
    packed = {
        "data": {
            "train": {"packed": True, "pack_window": 16},
            "dev": {"packed": True, "pack_window": 16},
        }
    }

    _, losses_full, _ = run_trainer(model_dir, tmp_path / "full", TOTAL_STEPS, extra_cfg=packed)
    assert len(losses_full) == TOTAL_STEPS

    _, losses_a, _ = run_trainer(model_dir, tmp_path / "int", HALF_STEPS, extra_cfg=packed)
    state_path = tmp_path / "int" / "training_state.msgpack"
    t2, losses_b, _ = run_trainer(
        model_dir=tmp_path / "int" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "resumed",
        max_steps=TOTAL_STEPS,
        training_state=state_path,
        extra_cfg=packed,
    )
    assert t2.global_step == TOTAL_STEPS
    assert losses_a + losses_b == losses_full, (
        f"Packed loss streams diverge:\nfull    ={losses_full}\ncombined={losses_a + losses_b}"
    )


@pytest.mark.parametrize("knob", ["zero1", "fsdp"])
def test_resume_zero1_optimizer_sharding(model_dir, tmp_path, monkeypatch, knob):
    """ZeRO-1 / FSDP (parallel.zero1 / parallel.fsdp): moments (and, under fsdp,
    params) dp-sharded on device, math agrees with the replicated run (fp
    reduction-order tolerance), and an interrupted run resumes bitwise — save
    gathers the shards, restore re-places them onto the dp layout."""
    import jax

    from ssi_jax.checkpoint import TRAINING_STATE_FNAME

    _patch_data(monkeypatch)
    z1 = {"parallel": {"dp": 2, "tp": 2, knob: True}}  # sft batch_size=2 -> dp<=2

    _, losses_repl, _ = run_trainer(model_dir, tmp_path / "repl", TOTAL_STEPS, mesh=(2, 2))
    t1, losses_z, _ = run_trainer(model_dir, tmp_path / "z", TOTAL_STEPS, extra_cfg=z1)

    mu_embed = t1.state["opt_state"]["mu"]["embed"]
    assert "dp" in jax.tree.leaves(tuple(mu_embed.sharding.spec))
    assert mu_embed.addressable_shards[0].data.size < mu_embed.size
    p_embed = t1.state["params"]["embed"]
    if knob == "fsdp":
        assert "dp" in jax.tree.leaves(tuple(p_embed.sharding.spec))
        assert p_embed.addressable_shards[0].data.size < p_embed.size
    else:
        assert "dp" not in jax.tree.leaves(tuple(p_embed.sharding.spec))

    for got, want in zip(losses_z, losses_repl):
        assert got == pytest.approx(want, rel=1e-5)

    # Interrupted-and-resumed zero1 run: bitwise continuation of the zero1 stream.
    _, losses_a, _ = run_trainer(model_dir, tmp_path / "int", HALF_STEPS, extra_cfg=z1)
    assert losses_a == losses_z[:HALF_STEPS]
    _, losses_b, _ = run_trainer(
        model_dir=tmp_path / "int" / f"step_{HALF_STEPS}",
        ckpt_dir=tmp_path / "res",
        max_steps=TOTAL_STEPS,
        training_state=tmp_path / "int" / TRAINING_STATE_FNAME,
        extra_cfg=z1,
    )
    assert losses_b == losses_z[HALF_STEPS:]
