"""End-to-end Trainer tests on the tiny model (CPU, hermetic).

The reference needs a GPU + downloaded model + network for these
(ref: tests/test_trainer_gpu.py:65-253); the registry-based tiny architecture
makes them plain CPU unit tests here.
"""

import numpy as np
import pytest

from tests import helpers


@pytest.fixture()
def trainer(tmp_path, synthetic_data):
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = helpers.make_cfg(helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="sft"))
    t = Trainer(cfg)
    yield t
    t.cleanup()


def test_setup_smoke(trainer):
    trainer.setup()
    assert trainer.state is not None
    assert trainer.geometry.steps_per_epoch > 0
    assert trainer.tokenizer.pad_id > 0
    assert trainer.global_step == 0


def test_single_step_finite_loss_and_param_change(trainer):
    import jax

    trainer.setup()
    before = jax.device_get(trainer.state["params"])
    losses = []
    trainer._loss_log = losses
    trainer.cfg.max_steps = 3  # warmup is 2 steps; step 3 has lr > 0
    trainer.train()
    assert len(losses) == 3
    assert all(np.isfinite(x) for x in losses)
    after = jax.device_get(trainer.state["params"])
    changed = any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after))
    )
    assert changed, "optimizer step must change parameters"
    assert trainer.global_step == 3
    assert trainer.consumed_samples == 3 * 2 * 2  # steps * accum * batch_size


def test_dev_loss_finite(trainer):
    trainer.setup()
    dev_loss = trainer._evaluate()
    assert np.isfinite(dev_loss)


def test_full_run_saves_checkpoints(trainer, tmp_path):
    trainer.setup()
    trainer.train()  # 8 steps; save_steps=4 -> step_4, step_8
    ckpt_root = tmp_path / "ckpts"
    assert (ckpt_root / "step_4").is_dir()
    assert (ckpt_root / "step_8").is_dir()
    assert (ckpt_root / "training_state.msgpack").is_file()
    assert (ckpt_root / "metrics.jsonl").is_file()
    # metrics logged per step
    assert len(trainer.metric_logger.history) >= 8
    record = trainer.metric_logger.history[-1]
    assert {"loss", "lr", "tokens_per_second_per_gpu", "tokens_total"} <= set(record)
    # token-type accounting accumulated
    assert trainer.token_type_counts_total["dsu"] > 0
    assert trainer.token_type_counts_total["total"] > 0


def test_token_counts_match_host_computation(trainer):
    """Device-side accounting equals the host reference implementation."""
    from ssi_jax.train.train_utils import count_token_types

    trainer.setup()
    batch = next(iter(trainer.data_train))
    host_counts = count_token_types(batch["tokens"], trainer.token_type_ranges, trainer.tokenizer.pad_id)

    import jax.numpy as jnp

    from ssi_jax.train.step import count_token_types_device

    dev_counts = count_token_types_device(jnp.asarray(batch["tokens"]), trainer.token_type_ranges, trainer.tokenizer.pad_id)
    for k, v in host_counts.items():
        assert int(dev_counts[k]) == v


def test_token_counts_padding_invariant(trainer):
    """Counts for the same samples are identical however much padding is appended
    (pad tokens must not leak into the special_text range)."""
    import numpy as np

    from ssi_jax.train.train_utils import count_token_types

    trainer.setup()
    batch = next(iter(trainer.data_train))
    tokens = np.asarray(batch["tokens"])
    pad_id = trainer.tokenizer.pad_id

    counts = count_token_types(tokens, trainer.token_type_ranges, pad_id)
    extra = np.full((tokens.shape[0], 37), pad_id, tokens.dtype)
    counts_padded = count_token_types(np.concatenate([tokens, extra], axis=1), trainer.token_type_ranges, pad_id)
    assert counts == counts_padded
    assert counts["total"] == sum(v for k, v in counts.items() if k != "total")


def test_cpt_trainer_runs(tmp_path, synthetic_data):
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="cpt")
    cfg_dict["max_steps"] = 2
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    losses = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)


def test_checkpoint_retention_and_async_save(tmp_path, synthetic_data):
    """Planned-but-unbuilt reference features F4/F5: retention policy + async save."""
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="sft")
    cfg_dict["max_steps"] = 6
    cfg_dict["save_steps"] = 2
    cfg_dict["eval_steps"] = 2
    cfg_dict["keep_last_n_checkpoints"] = 2
    cfg_dict["async_save"] = True
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    t.train()
    t.cleanup()  # joins the in-flight background save
    root = tmp_path / "ckpts"
    step_dirs = sorted(p.name for p in root.glob("step_*"))
    assert step_dirs == ["step_4", "step_6"], step_dirs  # step_2 pruned
    assert (root / "training_state.msgpack").is_file()
    # the kept checkpoints are loadable
    from ssi_jax.checkpoint import Checkpointer

    ck = Checkpointer(checkpoint_dir=root / "step_6", output_dir=tmp_path / "reload")
    params = ck.load_params(t._llama_config, dtype="float32")
    assert params["embed"].shape[0] == t._llama_config.vocab_size


def test_wsd_schedule_shape():
    import numpy as np

    from ssi_jax.train.lr_schedule import wsd_schedule

    sched = wsd_schedule(1.0, num_warmup_steps=10, num_training_steps=100, decay_fraction=0.2, min_lr_ratio=0.1)
    assert float(sched(0)) == 0.0
    assert float(sched(5)) == pytest.approx(0.5)
    assert float(sched(10)) == pytest.approx(1.0)
    assert float(sched(50)) == pytest.approx(1.0)  # stable plateau
    assert float(sched(79)) == pytest.approx(1.0)  # decay starts at 80
    assert float(sched(90)) == pytest.approx(0.55)  # halfway down to 0.1
    assert float(sched(100)) == pytest.approx(0.1)
    # plateau is independent of total steps (the WSD selling point)
    sched2 = wsd_schedule(1.0, 10, 1000, decay_fraction=0.2, min_lr_ratio=0.1)
    assert float(sched2(50)) == float(sched(50)) == 1.0


def test_profiler_hook(tmp_path, synthetic_data):
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="sft")
    cfg_dict["max_steps"] = 4
    cfg_dict["profiler"] = {"start_step": 1, "num_steps": 2, "dir": str(tmp_path / "trace")}
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    t.train()
    t.cleanup()
    assert not getattr(t, "_profiling", False)
    trace_files = list((tmp_path / "trace").rglob("*.pb")) + list((tmp_path / "trace").rglob("*.json.gz"))
    assert trace_files, "profiler trace files must exist"


def test_retention_spares_resume_source_dir(tmp_path, synthetic_data):
    """Pruning must never delete the step dir training resumed FROM — every
    later save copies configs out of it (a prune-then-save would crash)."""
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    # first run leaves step_2 / step_4 in the output dir
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="sft")
    cfg_dict["max_steps"] = 4
    cfg_dict["save_steps"] = 2
    cfg_dict["eval_steps"] = 2
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    t.train()
    t.cleanup()
    root = tmp_path / "ckpts"
    assert (root / "step_2").is_dir()

    # second run loads FROM step_2 and writes into the SAME dir with retention
    cfg_dict2 = helpers.base_train_cfg_dict(root / "step_2", root, kind="sft")
    cfg_dict2["max_steps"] = 8
    cfg_dict2["save_steps"] = 3
    cfg_dict2["eval_steps"] = 3
    cfg_dict2["keep_last_n_checkpoints"] = 2
    t2 = Trainer(helpers.make_cfg(cfg_dict2))
    t2.setup()
    t2.train()  # saves at 3, 6, and the final 8; prunes down to 2 + source
    t2.cleanup()
    names = sorted(p.name for p in root.glob("step_*"))
    assert "step_2" in names, "resume-source dir was pruned"
    assert {"step_6", "step_8"} <= set(names)


def test_overlap_io_equivalence(tmp_path, synthetic_data):
    """overlap_io (one dispatched window in flight, metrics synced one step
    late) must be observationally identical to the synchronous loop: same
    per-step losses (bitwise), same logged metrics, same checkpoint bytes.
    Eval/save/final steps exercise the synchronous fallback (the processing
    of those windows reads post-step state before the next dispatch donates
    it): max_steps=8 with save/eval at 4 covers boundary + steady-state."""
    from ssi_jax.train import Trainer

    def run(overlap: bool, tag: str):
        model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / f"model_{tag}")
        cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / f"ckpts_{tag}", kind="sft")
        cfg_dict["overlap_io"] = overlap
        t = Trainer(helpers.make_cfg(cfg_dict))
        t.setup()
        losses: list[float] = []
        t._loss_log = losses
        t.train()
        t.cleanup()
        return losses, t.metric_logger.history, t.tokens_train_total, dict(t.token_type_counts_total)

    loss_sync, hist_sync, tok_sync, tt_sync = run(False, "sync")
    loss_ovl, hist_ovl, tok_ovl, tt_ovl = run(True, "ovl")

    assert loss_ovl == loss_sync  # bitwise-equal loss stream
    assert tok_ovl == tok_sync and tt_ovl == tt_sync
    timing = {"duration_step", "tokens_per_second_per_gpu", "train_clock_time"}
    assert len(hist_ovl) == len(hist_sync)
    for a, b in zip(hist_ovl, hist_sync):
        assert {k: v for k, v in a.items() if k not in timing} == {
            k: v for k, v in b.items() if k not in timing
        }
    # checkpoints written at the same steps with identical model bytes (the
    # save fallback synced the right state before the next dispatch donated it)
    for step in (4, 8):
        for a_dir, b_dir in ((tmp_path / "ckpts_sync", tmp_path / "ckpts_ovl"),):
            a_shards = sorted((a_dir / f"step_{step}").glob("*.safetensors"))
            b_shards = sorted((b_dir / f"step_{step}").glob("*.safetensors"))
            assert a_shards and [p.name for p in a_shards] == [p.name for p in b_shards]
            for pa, pb in zip(a_shards, b_shards):
                assert pa.read_bytes() == pb.read_bytes(), (
                    f"step_{step}/{pa.name} differs between sync and overlap runs"
                )


def test_final_checkpoint_saved_at_max_steps(tmp_path, synthetic_data):
    """max_steps not divisible by save_steps: the run's end state must still
    be written (the reference never reaches max_steps; we do)."""
    from ssi_jax.train import Trainer

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg_dict = helpers.base_train_cfg_dict(model_dir, tmp_path / "ckpts", kind="sft")
    cfg_dict["max_steps"] = 5
    cfg_dict["save_steps"] = 4
    cfg_dict["eval_steps"] = 4
    t = Trainer(helpers.make_cfg(cfg_dict))
    t.setup()
    t.train()
    t.cleanup()
    names = sorted(p.name for p in (tmp_path / "ckpts").glob("step_*"))
    assert names == ["step_4", "step_5"], names
