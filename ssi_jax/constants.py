"""Project-wide constants.

JAX rebuild of the constants surface of the reference stack
(ref: ssi/constants.py:1-97). Paths are configurable via the ``SSI_JAX_HOME``
environment variable instead of the reference's hard-coded cluster paths.
"""

from __future__ import annotations

import os
from pathlib import Path

####################################################################################################
# Seed (ref: ssi/constants.py:12-13 — cross-checked against sardalign)
####################################################################################################

SEED: int = 42_831

####################################################################################################
# Supported datasets / encoders (ref: ssi/constants.py:21-24)
####################################################################################################

SUPPORTED_DATASETS: set[str] = {"mls", "voxpopuli", "librispeech", "gigaspeech"}
SUPPORTED_SPEECH_ENCODERS: set[str] = {"hubert_large_ll60k-layer_22", "speechtokenizer-rvq_0"}
HF_OWNER: str = "anilkeshwani"
SUPPORTED_DTYPES: set[str] = {"fp32", "bf16"}

# W&B (ref: ssi/constants.py:27-29)
DEBUGGING_TAG: str = "trial-run"
WANDB_ENTITY_DEFAULT: str = "anilkeshwani"
WANDB_PROJECT_DEFAULT: str = "speech-integration"

# Defaults used before these became experimentation parameters
N_DSUS_DEFAULT: int = 5_000

####################################################################################################
# Checkpoints and artefacts (ref: ssi/constants.py:39-50)
####################################################################################################

HOME_DIR = Path(os.environ.get("SSI_JAX_HOME", os.environ.get("HAFH", str(Path.home() / "ssi_jax"))))
BASE_MODELS_DIR = HOME_DIR / "models" / "base"
EXTENDED_MODELS_DIR = HOME_DIR / "models" / "extended"
LLAMA_3_2_1B_BASE_DIR = BASE_MODELS_DIR / "Llama-3.2-1B"
LLAMA_3_2_3B_BASE_DIR = BASE_MODELS_DIR / "Llama-3.2-3B"

# Relative paths inside an HF-format Llama 3.2 model directory
LLAMA_3_2_TOKENIZER_RELPATH = Path("original", "tokenizer.model")
LLAMA_3_2_MODEL_RELPATH = Path("model.safetensors")
LLAMA_3_2_CONFIG_RELPATH = Path("config.json")
LLAMA_3_2_GENERATION_CONFIG_RELPATH = Path("generation_config.json")
LLAMA_3_2_PARAMS_RELPATH = Path("original", "params.json")

# Llama 3.2 tokenizer
LLAMA_BOS_TOKEN = "<|begin_of_text|>"
LLAMA_EOS_TOKEN = "<|end_of_text|>"

# Resolved-config snapshot filename written to the checkpoint dir (ref: ssi/constants.py:56)
TRAIN_CONFIG_FILENAME = "torchtune_config.yaml"  # kept for drop-in compatibility with ref tooling

####################################################################################################
# Checkpoint schema v1 keys (ref: ssi/constants.py:61-97)
####################################################################################################

EPOCHS_KEY: str = "epochs_run"
MODEL_KEY: str = "model"
OPTIMIZER_KEY: str = "optimizer"
SEED_KEY: str = "seed"
TOTAL_EPOCHS_KEY: str = "total_epochs"
GLOBAL_STEP_KEY: str = "global_step"
RNG_KEY: str = "rng_state"

TRAINING_HPARAMS_KEY: str = "training_hparams"
LR_SCHEDULER_KEY: str = "lr_scheduler"
CONSUMED_SAMPLES_KEY: str = "consumed_samples"
CUMULATIVE_METRICS_KEY: str = "cumulative_metrics"
CHECKPOINT_VERSION_KEY: str = "checkpoint_version"
CHECKPOINT_VERSION: int = 1

# Loss ignore index (torch cross-entropy convention, kept for data-format compatibility)
CROSS_ENTROPY_IGNORE_IDX: int = -100

# Keys reserved for the collated batch (ref: ssi/constants.py:97)
RESERVED_BATCH_KEYS: set[str] = {"tokens", "mask", "labels"}
