"""Llama 3.2 model hyperparameter configs.

JAX rebuild of the reference's config dataclass (ref: ssi/llama_configs.py:29-155):
vocab size is derived dynamically from base text vocab + special tokens + DSU tokens
+ optional modality tokens, and checkpoint expectations are produced for validation.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, NamedTuple


class ModelCheckpointExpectations(NamedTuple):
    """Expected checkpoint structure for a model architecture (used in validation)."""

    model_name: str
    n_shards: int
    num_layers: int
    hidden_size: int
    vocab_size: int


@dataclass
class ConfigLlama3_2:
    """Llama 3.2 hyperparameters with dynamic vocab arithmetic.

    ``vocab_size = base_vocab_size_txt + n_special_txt + n_dsus + 2*modality_tokens``
    (ref: ssi/llama_configs.py:97-99).
    """

    base_vocab_size_txt: int
    n_special_txt: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    embed_dim: int
    max_seq_len: int
    intermediate_dim: int
    attn_dropout: float
    norm_eps: float
    rope_base: int
    scale_factor: int
    n_dsus: int = 0
    modality_tokens: bool = False
    # Llama 3.2 1B/3B tie the output projection to the embedding (the reference's
    # TiedLinear, ref: ssi/extend_llama3_2/__init__.py:102); Llama 3.1 8B ships a
    # separate lm_head.
    tied_embeddings: bool = True
    # RoPE llama3-scaling shape parameters (fixed across Llama 3.x releases)
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_seq_len: int = 8192
    # HF hub checkpoint shard count (1B ships 1 shard; 3B ships 2)
    n_checkpoint_shards: int = 1

    def __post_init__(self) -> None:
        if not isinstance(self.n_dsus, int) or self.n_dsus < 0:
            raise ValueError("n_dsus must be a non-negative integer")
        if not isinstance(self.modality_tokens, bool):
            raise ValueError("modality_tokens must be boolean")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def update_from_speech_cfg(self, cfg_speech: Any) -> None:
        """In-place update of speech-specific hyperparameters from a config node."""
        n_dsus = cfg_speech.n_dsus
        use_modality_tokens = cfg_speech.use_modality_tokens
        if not isinstance(n_dsus, int) or n_dsus < 0:
            raise ValueError("n_dsus must be a non-negative integer")
        if not isinstance(use_modality_tokens, bool):
            raise ValueError("use_modality_tokens must be boolean")
        self.n_dsus = n_dsus
        self.modality_tokens = use_modality_tokens

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size_txt + self.n_special_txt + self.n_dsus + (2 * self.modality_tokens)

    @property
    def checkpoint_expectations(self) -> ModelCheckpointExpectations:
        size_label = {2048: "1B", 3072: "3B", 4096: "8B"}.get(self.embed_dim, f"{self.embed_dim}d")
        family = "3.1" if self.embed_dim == 4096 else "3.2"
        return ModelCheckpointExpectations(
            model_name=f"Llama {family} {size_label}",
            n_shards=self.n_checkpoint_shards,
            num_layers=self.num_layers,
            hidden_size=self.embed_dim,
            vocab_size=self.vocab_size,
        )

    def copy(self) -> "ConfigLlama3_2":
        return replace(self)


configllama3_2_1b = ConfigLlama3_2(
    base_vocab_size_txt=128_000,
    n_special_txt=256,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    embed_dim=2048,
    max_seq_len=131072,
    intermediate_dim=8192,
    attn_dropout=0.0,
    norm_eps=1e-5,
    rope_base=500_000,
    scale_factor=32,
)

configllama3_2_3b = ConfigLlama3_2(
    base_vocab_size_txt=128_000,
    n_special_txt=256,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    embed_dim=3072,
    max_seq_len=131072,
    intermediate_dim=8192,
    attn_dropout=0.0,
    norm_eps=1e-5,
    rope_base=500_000,
    scale_factor=32,
    n_checkpoint_shards=2,  # meta-llama/Llama-3.2-3B ships model-0000{1,2}-of-00002
)

# BASELINE "stretch" scale (Llama-3-8B): the Llama 3.1 8B architecture with the
# same dynamic DSU-vocab arithmetic. Training state (bf16 params + moments +
# grads, ~64 GB before activations) is the four-card FSDP target; bf16 decode
# (~16 GB of weights + KV) fits one 80 GB card.
configllama3_1_8b = ConfigLlama3_2(
    base_vocab_size_txt=128_000,
    n_special_txt=256,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    embed_dim=4096,
    max_seq_len=131072,
    intermediate_dim=14336,
    attn_dropout=0.0,
    norm_eps=1e-5,
    rope_base=500_000,
    scale_factor=8,  # Llama 3.1 rope scaling factor (3.2's 1B/3B use 32)
    n_checkpoint_shards=4,  # meta-llama/Llama-3.1-8B ships model-0000{1..4}-of-00004
    tied_embeddings=False,  # 8B has a separate lm_head (1B/3B tie)
)

# Pilot-scale member of the Llama-3.2 geometry (NOT a Meta release): same
# vocab arithmetic / head_dim 64 / GQA / RoPE scaling as the 1B, scaled to
# ~100M params so it is trainable from random init within a single-chip token
# budget. tools/wer_drive.py uses it to drive the full extend -> train_sft ->
# generate -> wer pipeline to a near-zero WER operating point: the pipeline
# demonstration needs a model that can actually converge on the drive's
# ~60M-token budget, which a from-scratch 1B cannot (ref context:
# scripts/wer.py:59-73 scores pretrained checkpoints; offline we must train
# the checkpoint we score).
configllama3_2_100m = ConfigLlama3_2(
    base_vocab_size_txt=128_000,
    n_special_txt=256,
    num_layers=8,
    num_heads=8,
    num_kv_heads=4,
    embed_dim=512,
    max_seq_len=131072,
    intermediate_dim=2048,
    attn_dropout=0.0,
    norm_eps=1e-5,
    rope_base=500_000,
    scale_factor=32,
)

# Tiny architecture for CPU tests and CI smoke runs (not a reference model).
config_tiny_test = ConfigLlama3_2(
    base_vocab_size_txt=256,
    n_special_txt=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    embed_dim=64,
    max_seq_len=2048,
    intermediate_dim=128,
    attn_dropout=0.0,
    norm_eps=1e-5,
    rope_base=500_000,
    scale_factor=32,
)

# Registry keyed by the `model_config` config field; the reference hardcodes the 1B
# factory (ref: ssi/trainer.py:240) — a registry keeps tests and future models first-class.
MODEL_CONFIGS: dict[str, ConfigLlama3_2] = {
    "llama3_2_100m": configllama3_2_100m,
    "llama3_2_1b": configllama3_2_1b,
    "llama3_2_3b": configllama3_2_3b,
    "llama3_1_8b": configllama3_1_8b,
    "tiny_test": config_tiny_test,
}


def get_model_config(name: str) -> ConfigLlama3_2:
    try:
        return MODEL_CONFIGS[name]
    except KeyError:
        raise KeyError(f"Unknown model_config {name!r}. Available: {sorted(MODEL_CONFIGS)}") from None
