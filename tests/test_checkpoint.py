"""Checkpoint schema + serialization contracts (ref: tests/test_checkpoint.py:68-371)."""

from pathlib import Path
import random

import numpy as np
import pytest

from ssi_jax.checkpoint import (
    Checkpointer,
    check_outdir_not_in_ckptdir,
    discover_safetensor_files,
    pack_state,
    restore_rng_states,
    save_rng_states,
    unpack_state,
)
from ssi_jax.constants import (
    CHECKPOINT_VERSION,
    CHECKPOINT_VERSION_KEY,
    CONSUMED_SAMPLES_KEY,
    CUMULATIVE_METRICS_KEY,
    GLOBAL_STEP_KEY,
    LR_SCHEDULER_KEY,
    OPTIMIZER_KEY,
    RNG_KEY,
    SEED,
    SEED_KEY,
    TRAINING_HPARAMS_KEY,
)
from ssi_jax.train.train_utils import resume_training_state
from tests import helpers


@pytest.fixture()
def v1_state():
    return {
        CHECKPOINT_VERSION_KEY: CHECKPOINT_VERSION,
        GLOBAL_STEP_KEY: 42,
        SEED_KEY: SEED,
        OPTIMIZER_KEY: {"mu": {"w": np.ones((2, 2), np.float32)}, "count": 42},
        LR_SCHEDULER_KEY: {"last_step": 42},
        RNG_KEY: save_rng_states(),
        TRAINING_HPARAMS_KEY: {
            "batch_size": 2,
            "gradient_accumulation_steps": 2,
            "world_size": 1,
            "steps_per_epoch": 10,
        },
        CONSUMED_SAMPLES_KEY: 168,
        CUMULATIVE_METRICS_KEY: {
            "tokens_train_total": 1000,
            "token_type_counts": {"text": 1, "dsu": 2},
            "wall_clock_seconds": 1.5,
        },
    }


# --- schema contract (ref: tests/test_checkpoint.py:98-180) -----------------------


def test_resume_training_state_roundtrip(v1_state):
    out = resume_training_state(v1_state)
    assert out["global_step"] == 42
    assert out["consumed_samples"] == 168
    assert out["training_hparams"]["steps_per_epoch"] == 10


def test_resume_rejects_unversioned(v1_state):
    del v1_state[CHECKPOINT_VERSION_KEY]
    with pytest.raises(ValueError, match="versioned schema"):
        resume_training_state(v1_state)


def test_resume_rejects_version_mismatch(v1_state):
    v1_state[CHECKPOINT_VERSION_KEY] = 999
    with pytest.raises(ValueError, match="version mismatch"):
        resume_training_state(v1_state)


def test_resume_rejects_seed_mismatch(v1_state):
    v1_state[SEED_KEY] = 1
    with pytest.raises(ValueError, match="Seed mismatch"):
        resume_training_state(v1_state)


def test_resume_missing_key_raises(v1_state):
    del v1_state[OPTIMIZER_KEY]
    with pytest.raises(KeyError):
        resume_training_state(v1_state)


# --- msgpack state serialization --------------------------------------------------


def test_pack_unpack_nested_arrays(v1_state):
    data = pack_state(v1_state)
    out = unpack_state(data)
    assert out[GLOBAL_STEP_KEY] == 42
    np.testing.assert_array_equal(out[OPTIMIZER_KEY]["mu"]["w"], np.ones((2, 2), np.float32))
    assert out[OPTIMIZER_KEY]["mu"]["w"].dtype == np.float32


def test_pack_unpack_bfloat16():
    import ml_dtypes

    arr = np.arange(8, dtype=np.float32).astype(ml_dtypes.bfloat16)
    out = unpack_state(pack_state({"x": arr}))
    assert out["x"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(out["x"].astype(np.float32), arr.astype(np.float32))


def test_rng_states_roundtrip():
    """ref: tests/test_checkpoint.py:347-371."""
    random.seed(123)
    np.random.seed(456)
    state = unpack_state(pack_state(save_rng_states()))  # through serialization
    py_expected = random.random()
    np_expected = np.random.random()
    random.seed(999)
    np.random.seed(999)
    restore_rng_states(state)
    assert random.random() == py_expected
    assert np.random.random() == np_expected


# --- discovery / validation -------------------------------------------------------


def test_discover_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        discover_safetensor_files(tmp_path / "nope")


def test_discover_empty_dir(tmp_path):
    with pytest.raises(ValueError, match="No safetensors"):
        discover_safetensor_files(tmp_path)


def test_discover_ambiguous(tmp_path):
    (tmp_path / "model-00001-of-00001.safetensors").touch()
    (tmp_path / "ft-model-00001-of-00001.safetensors").touch()
    with pytest.raises(ValueError, match="Ambiguous"):
        discover_safetensor_files(tmp_path)


def test_outdir_inside_ckptdir_rejected(tmp_path):
    with pytest.raises(ValueError, match="must not be inside"):
        check_outdir_not_in_ckptdir(tmp_path, tmp_path / "sub")
    check_outdir_not_in_ckptdir(tmp_path / "a", tmp_path / "b")  # siblings OK


# --- HF round-trip through disk (tiny model) ---------------------------------------


def test_hf_checkpoint_roundtrip(tmp_path):
    import jax

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = helpers.tiny_config()
    ckptr = Checkpointer(checkpoint_dir=model_dir, output_dir=tmp_path / "out")
    params = ckptr.load_params(cfg, dtype="float32")
    assert params["embed"].shape == (cfg.vocab_size, cfg.embed_dim)
    assert params["layers"]["wq"].shape == (cfg.num_layers, cfg.embed_dim, cfg.num_heads * cfg.head_dim)

    step_dir = ckptr.save_model_checkpoint(params, cfg, global_step=7)
    assert step_dir == tmp_path / "out" / "step_7"
    assert (step_dir / "config.json").exists()
    assert (step_dir / "original" / "tokenizer.model").exists()
    assert (step_dir / "model.safetensors.index.json").exists()

    # Reload from the step dir: exact round-trip
    ckptr2 = Checkpointer(checkpoint_dir=step_dir, output_dir=tmp_path / "out2")
    params2 = ckptr2.load_params(cfg, dtype="float32")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_wrong_vocab_rejected(tmp_path):
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = helpers.tiny_config(n_dsus=999)
    ckptr = Checkpointer(checkpoint_dir=model_dir, output_dir=tmp_path / "out")
    with pytest.raises(ValueError, match="vocab"):
        ckptr.load_params(cfg, dtype="float32")


def test_validation_catches_config_mismatch(tmp_path):
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = helpers.tiny_config()
    bad = cfg.copy()
    bad.num_layers = 5
    with pytest.raises(ValueError, match="num_hidden_layers"):
        Checkpointer(
            checkpoint_dir=model_dir,
            output_dir=tmp_path / "out",
            model_expectations=bad.checkpoint_expectations,
        )


def test_orbax_save_overwrites_stale_uncommitted_dir(tmp_path):
    """A crash between the Orbax optimizer save and the msgpack commit leaves a
    stale step dir; re-saving at the same step after resume must overwrite it
    instead of failing forever (advisor finding, checkpoint/orbax_io.py)."""
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp

    from ssi_jax.checkpoint.orbax_io import _DIR_PREFIX, save_opt_state

    opt_state = {"mu": {"w": jnp.arange(4, dtype=jnp.float32)}, "count": jnp.int32(3)}
    marker = save_opt_state(opt_state, tmp_path, step=7)
    assert (tmp_path / marker["__orbax_dir__"]).is_dir()

    # simulate the crashed-then-resumed run reaching step 7 again with different values
    opt_state2 = {"mu": {"w": jnp.arange(4, dtype=jnp.float32) * 2}, "count": jnp.int32(3)}
    marker2 = save_opt_state(opt_state2, tmp_path, step=7)
    assert marker2 == marker
    assert len(list(tmp_path.glob(f"{_DIR_PREFIX}*"))) == 1


def test_pth_weights_not_copied_into_step_dirs(tmp_path):
    """original/consolidated.00.pth (2.4 GB in a stock Meta download) must not
    be duplicated into every step_N dir."""
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    (model_dir / "original" / "consolidated.00.pth").write_bytes(b"\x00" * 64)
    cfg = helpers.tiny_config()
    ckptr = Checkpointer(checkpoint_dir=model_dir, output_dir=tmp_path / "out")
    params = ckptr.load_params(cfg, dtype="float32")
    step_dir = ckptr.save_model_checkpoint(params, cfg, global_step=1)
    assert (step_dir / "original" / "tokenizer.model").exists()  # configs copied
    assert not (step_dir / "original" / "consolidated.00.pth").exists()


def test_explicit_checkpoint_files_disambiguate_mixed_dir(tmp_path):
    """A dir holding BOTH base and ft shards: auto-discovery refuses with an
    instruction to pass checkpoint_files; doing so must actually work even
    with model_expectations (shard count checked against the explicit list)."""
    import shutil

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    plain = next(model_dir.glob("*.safetensors"))
    ft = model_dir / "ft-model-00001-of-00001.safetensors"
    plain.rename(ft)
    shutil.copy(ft, model_dir / "model-00001-of-00001.safetensors")  # fake base shard
    cfg = helpers.tiny_config()
    with pytest.raises(ValueError, match="checkpoint_files"):
        Checkpointer(checkpoint_dir=model_dir, output_dir=tmp_path / "out")
    ckptr = Checkpointer(
        checkpoint_dir=model_dir,
        output_dir=tmp_path / "out",
        checkpoint_files=[ft.name],
        model_expectations=cfg.checkpoint_expectations,
    )
    params = ckptr.load_params(cfg, dtype="float32")
    assert params["embed"].shape[0] == cfg.vocab_size
