"""Config system tests: composition, interpolation, overrides, missing keys.

This module replaces Hydra/OmegaConf (ref: conf/cpt.yaml defaults list,
conf/common.yaml interpolations, ssi/train_utils.py:71 missing_keys) — it is
load-bearing for every entry point, so its semantics get their own suite.
"""

from pathlib import Path

import pytest

from ssi_jax.config import (
    MISSING,
    Config,
    InterpolationError,
    MissingMandatoryValue,
    compose,
    missing_keys,
    to_container,
    to_yaml,
)

CONF = Path(__file__).resolve().parent.parent / "conf"


def test_compose_real_tree_cpt():
    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22"])
    assert cfg.config_name == "cpt"
    assert cfg.tokenizer.max_seq_len == 768
    assert cfg.data.n_dsus == 5000
    assert cfg.data.train.dataset.sequence_type == "interleaved"
    assert cfg.optimizer.lr == 2e-4
    assert missing_keys(cfg) == set()


def test_compose_mandatory_group_enforced():
    with pytest.raises(MissingMandatoryValue, match="data"):
        compose(str(CONF), "cpt", overrides=[])


def test_interpolation_chains_and_updates():
    cfg = compose(str(CONF), "sft", overrides=["data=sft/mls-mimi-srvq_0"])
    assert cfg.speech.n_dsus is None
    cfg.speech.n_dsus = 2048  # late assignment must flow through interpolations
    assert cfg.extended_model_name == "Llama-3.2-1B-2048-dsus"
    assert cfg.checkpointer.checkpoint_dir.endswith("models/extended/Llama-3.2-1B-2048-dsus")


def test_value_overrides_typed():
    cfg = compose(
        str(CONF),
        "cpt",
        overrides=[
            "data=cpt/mls-focalcodec",
            "max_steps=7",
            "optimizer.lr=1e-5",
            "clip_grad_norm=1.0",
            "lr_scheduler=null",
            "speech.use_modality_tokens=false",
        ],
    )
    assert cfg.max_steps == 7 and isinstance(cfg.max_steps, int)
    assert cfg.optimizer.lr == 1e-5
    assert cfg.get("lr_scheduler") is None
    assert cfg.speech.use_modality_tokens is False
    # interpolated consumer sees the override
    assert cfg.data.train.dataset.use_modality_tokens is False


def test_plus_prefix_adds_new_key():
    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-focalcodec", "+data.train.dataset.data_files=/x.jsonl"])
    assert cfg.data.train.dataset.data_files == "/x.jsonl"


def test_missing_marker_raises_on_access():
    cfg = Config({"a": MISSING, "b": 1})
    assert cfg.b == 1
    with pytest.raises(MissingMandatoryValue):
        _ = cfg.a
    assert missing_keys(cfg) == {"a"}
    assert cfg.get("a", "fallback") == "fallback"


def test_env_resolver(monkeypatch):
    monkeypatch.setenv("SSI_JAX_HOME", "/custom/home")
    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-focalcodec"])
    assert cfg.extended_models_dir == "/custom/home/models/extended"
    monkeypatch.delenv("SSI_JAX_HOME")
    cfg2 = compose(str(CONF), "cpt", overrides=["data=cpt/mls-focalcodec"])
    assert cfg2.extended_models_dir.startswith("ssi_jax_home/")


def test_unknown_interpolation_errors():
    cfg = Config({"x": "${nope.nothing}"})
    with pytest.raises(InterpolationError):
        _ = cfg.x


def test_to_yaml_roundtrip_resolves():
    cfg = compose(str(CONF), "sft", overrides=["data=sft/mls-hubert_large_ll60k-layer_22", "speech.n_dsus=5000"])
    text = to_yaml(cfg, resolve=True)
    assert "Llama-3.2-1B-5000-dsus" in text
    assert "${" not in text  # fully resolved
    container = to_container(cfg, resolve=True)
    assert container["data"]["train"]["dataset"]["deduplicate"] is True


def test_select_and_setdefault():
    cfg = Config({"a": {"b": 2}})
    assert cfg.select("a.b") == 2
    assert cfg.select("a.zz", default=9) == 9
    cfg.setdefault("c", 3)
    assert cfg.c == 3


def test_embedded_interpolation_stringifies():
    cfg = Config({"name": "m", "n": 5, "derived": "${name}-${n}-dsus"})
    assert cfg.derived == "m-5-dsus"


def test_job_logging_group_surface(tmp_path):
    """hydra/job_logging config group (ref: conf/hydra/job_logging/custom.yaml):
    default selection resolves the yaml, `none` disables, unknown names fail."""
    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22"])
    assert cfg.hydra.job_logging == "custom"
    assert cfg.hydra.job_logging_config.endswith("hydra/job_logging/custom.yaml")

    cfg_off = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22", "hydra/job_logging=none"])
    assert cfg_off.hydra.job_logging == "none"
    assert cfg_off.select("hydra.job_logging_config", default=None) is None

    with pytest.raises(FileNotFoundError, match="job_logging"):
        compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22", "hydra/job_logging=nope"])


def test_job_logging_applied_at_runtime(tmp_path):
    """configure_job_logging substitutes the reference placeholders and wires a
    per-run file handler through logging.config.dictConfig."""
    import logging

    from ssi_jax.train.metric_logging import configure_job_logging

    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22"])
    run_dir = tmp_path / "run"
    configure_job_logging(cfg, run_dir, job_name="cpt")
    try:
        logging.getLogger("ssi_jax.test_job_logging").info("hello from dictConfig")
        logging.shutdown()
        log_file = run_dir / "cpt.log"
        assert log_file.is_file()
        assert "hello from dictConfig" in log_file.read_text()
    finally:
        # dictConfig replaced global handlers; restore a sane default for other tests
        root = logging.getLogger()
        for h in list(root.handlers):
            root.removeHandler(h)
        logging.basicConfig(level=logging.INFO)


def test_hydra_logging_group_surface(tmp_path):
    """hydra/hydra_logging config group (ref: conf/hydra/hydra_logging/custom.yaml):
    default selection resolves the yaml, `none` disables, unknown names fail."""
    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22"])
    assert cfg.hydra.hydra_logging == "custom"
    assert cfg.hydra.hydra_logging_config.endswith("hydra/hydra_logging/custom.yaml")

    cfg_off = compose(
        str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22", "hydra/hydra_logging=none"]
    )
    assert cfg_off.hydra.hydra_logging == "none"
    assert cfg_off.select("hydra.hydra_logging_config", default=None) is None

    with pytest.raises(FileNotFoundError, match="hydra_logging"):
        compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22", "hydra/hydra_logging=nope"])


def test_hydra_logging_applied_at_runtime(capsys):
    """configure_hydra_logging installs the HYDRA-tagged console handler that
    frames composition/startup messages (framework-phase logging)."""
    import logging

    from ssi_jax.train.metric_logging import configure_hydra_logging

    cfg = compose(str(CONF), "cpt", overrides=["data=cpt/mls-hubert_large_ll60k-layer_22"])
    try:
        configure_hydra_logging(cfg)
        logging.getLogger("ssi_jax.test_hydra_logging").info("composed ok")
        out = capsys.readouterr().out
        assert "HYDRA" in out and "composed ok" in out  # tolerate colorlog escapes around the tag
        # `none` and composer-less configs are no-ops
        configure_hydra_logging(Config({"hydra": {"hydra_logging": "none"}}))
        configure_hydra_logging(Config({}))
    finally:
        root = logging.getLogger()
        for h in list(root.handlers):
            root.removeHandler(h)
        logging.basicConfig(level=logging.INFO)


def test_extract_wandb_run_cfg_duck_typed():
    """W&B API Run -> sanitized Config (ref: ssi/utils.py:90-93), no wandb import."""
    import json
    from types import SimpleNamespace

    from ssi_jax.utils import extract_wandb_run_cfg, sanitize_wandb_run_json_config

    raw = {
        "optimizer": {"desc": None, "value": {"lr": 2e-4}},
        "seed": {"desc": "rng", "value": 42831},
        "_wandb": {"desc": None, "value": {"cli_version": "0.0"}},
    }
    assert sanitize_wandb_run_json_config(raw) == {"optimizer": {"lr": 2e-4}, "seed": 42831}
    cfg = extract_wandb_run_cfg(SimpleNamespace(json_config=json.dumps(raw)))
    assert cfg.optimizer.lr == 2e-4
    assert cfg["seed"] == 42831
    assert "_wandb" not in cfg
