"""General utilities (ref: ssi/utils.py:1-158, torch-free).

ASR/WER helpers (generations.jsonl parsing, HF reference transcripts), experiment
path parsing, config hashing, W&B config extraction, HF repo-id parsing, and
terminal helpers.
"""

from __future__ import annotations

from hashlib import sha256
import json
import os
from pathlib import Path
import pdb
import sys
import traceback
from typing import Any

from ssi_jax.constants import HF_OWNER

################################################################################
# ASR / WER Eval
################################################################################


def extract_texts_from_generations_jsonl(generations_jsonl: Path) -> list[str]:
    """One generated text per prompt (ref: ssi/utils.py:29-39)."""
    texts = []
    with open(generations_jsonl) as f:
        for line in f:
            data = json.loads(line)
            is_single_generation = len(data["outputs"]) == 1
            if is_single_generation:
                texts.append(data.pop("outputs").pop(0).pop("text"))
            else:
                raise NotImplementedError("Multiple generations per prompt are not supported by this script.")
    return texts


def ref_from_hf_dataset(dataset: str, split: str, gt_transcript_colname: str = "transcript") -> list[str]:
    """Ground-truth transcripts from the HF hub (ref: ssi/utils.py:42-47)."""
    from datasets import load_dataset

    if split == "dev":
        split = "validation"
    repo_id = HF_OWNER + "/" + dataset
    ds = load_dataset(repo_id, split=split)
    return list(ds[gt_transcript_colname])


################################################################################
# General
################################################################################


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (shape/bucket alignment helper)."""
    return ((n + multiple - 1) // multiple) * multiple


def parse_model_path(model_dir: Path, experiments_root_dir: Path) -> dict[str, Any]:
    """Parse a canonical model directory path (ref: ssi/utils.py:55-77)."""
    if not model_dir.is_relative_to(experiments_root_dir):
        raise ValueError(
            f"Model directory must be in the experiments root directory. "
            f"Got model_dir: {model_dir}. experiments_root_dir: {experiments_root_dir}"
        )
    model_training, wandb_dir, _, epoch_dir, global_step_dir = model_dir.relative_to(experiments_root_dir).parts
    *wandb_run_name_parts, wandb_run_id_prefixed = wandb_dir.split("-")
    wandb_run_name = "-".join(wandb_run_name_parts)
    wandb_run_id = wandb_run_id_prefixed.removeprefix("id_")
    *extended_model_parts, training_type = model_training.split("-")
    extended_model_name = "-".join(extended_model_parts)
    epoch = int(epoch_dir.removeprefix("epoch_"))
    global_step = int(global_step_dir.removeprefix("global_step_"))
    return {
        "extended_model_name": extended_model_name,
        "training_type": training_type,
        "wandb_run_id": wandb_run_id,
        "wandb_run_name": wandb_run_name,
        "epoch": epoch,
        "global_step": global_step,
    }


def hash_cfg(cfg: Any, length: int = 7) -> str:
    """Truncated SHA-256 of the resolved, key-sorted config (ref: ssi/utils.py:80-82)."""
    from ssi_jax.config import to_yaml

    return sha256(to_yaml(cfg, resolve=True, sort_keys=True).encode()).hexdigest()[:length]


def sanitize_wandb_run_json_config(run_json_config: dict) -> dict:
    """W&B top-level format: {"key": {"desc": str, "value": any}} (ref: ssi/utils.py:85-87)."""
    return {k: v["value"] for k, v in run_json_config.items() if k != "_wandb"}


def extract_wandb_run_cfg(run: Any) -> Any:
    """Sanitised config from a W&B API Run object (ref: ssi/utils.py:90-93).

    Duck-typed on ``run.json_config`` (wandb.apis.public.runs.Run) so callers —
    e.g. scripts/plot_wandb_losses.py pulling historical runs from the W&B API —
    work without importing wandb here. Returns a Config (our OmegaConf-subset
    container, attribute+key access like the reference's DictConfig).
    """
    import json as _json

    from ssi_jax.config import Config

    return Config(sanitize_wandb_run_json_config(_json.loads(run.json_config)))


def parse_hf_repo_id(repo_id: str) -> dict[str, str]:
    """Parse "owner/<dataset>-<speech_encoder>-<encoder_layer>" (ref: ssi/utils.py:95-109)."""
    owner, train_dataset_name = repo_id.split("/")
    dataset, speech_encoder, encoder_layer = train_dataset_name.split("-")
    return {"dataset": dataset, "speech_encoder": speech_encoder, "encoder_layer": encoder_layer, "repo_owner": owner}


def info_excepthook(type, value, tb):
    """Drop into pdb post-mortem on crash in a tty (ref: ssi/utils.py:112-119)."""
    if hasattr(sys, "ps1") or not sys.stderr.isatty():
        sys.__excepthook__(type, value, tb)
    else:
        traceback.print_exception(type, value, tb)
        pdb.post_mortem(tb)


def get_terminal_width(default_width: int = 120) -> int:
    try:
        return os.get_terminal_size().columns
    except OSError:
        return default_width
