"""Shared test helpers: tiny tokenizer/model/dataset builders.

The reference test suite streams small HF subsets and requires a downloaded
extended model for disk tests (ref: tests/conftest.py:19-32). This suite is fully
hermetic: a 256-entry byte-level BPE file, a tiny ConfigLlama3_2, and synthetic
aligned rows replace the network/model dependencies.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

TINY_N_DSUS = 16
TINY_USE_MODALITY = True


def write_tiny_tokenizer(path: Path) -> Path:
    """256 byte-level tokens — a valid, loadable tiktoken BPE file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for i in range(256):
            f.write(base64.b64encode(bytes([i])).decode() + f" {i}\n")
    return path


def tiny_config(n_dsus: int = TINY_N_DSUS, modality_tokens: bool = TINY_USE_MODALITY):
    from ssi_jax.models.configs import config_tiny_test

    cfg = config_tiny_test.copy()
    cfg.n_dsus = n_dsus
    cfg.modality_tokens = modality_tokens
    return cfg


def make_tiny_hf_checkpoint(model_dir: Path, n_dsus: int = TINY_N_DSUS, modality: bool = TINY_USE_MODALITY) -> Path:
    """Write a self-contained extended HF model dir for the tiny architecture.

    Layout matches what scripts/extend_llama3_2.py produces: fp32 safetensors with
    HF keys, config.json, generation_config.json, original/{tokenizer.model,params.json}.
    """
    import jax
    import jax.numpy as jnp
    from safetensors.numpy import save_file

    from ssi_jax.checkpoint.convert import internal_to_hf
    from ssi_jax.extend import extend_tiktoken
    from ssi_jax.models.llama3 import init_params

    model_dir = Path(model_dir)
    (model_dir / "original").mkdir(parents=True, exist_ok=True)
    cfg = tiny_config(n_dsus, modality)

    params = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    hf_state = internal_to_hf(jax.device_get(params), cfg, xp=np)
    save_file(
        {k: np.ascontiguousarray(np.asarray(v)) for k, v in hf_state.items()},
        str(model_dir / "model.safetensors"),
    )

    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "vocab_size": cfg.vocab_size,
        "bos_token_id": cfg.base_vocab_size_txt + cfg.n_dsus + 2 * cfg.modality_tokens,
        "eos_token_id": cfg.base_vocab_size_txt + cfg.n_dsus + 2 * cfg.modality_tokens + 1,
        "tie_word_embeddings": True,
        "rope_theta": float(cfg.rope_base),
        "max_position_embeddings": cfg.max_seq_len,
    }
    (model_dir / "config.json").write_text(json.dumps(config, indent=2))
    (model_dir / "generation_config.json").write_text(
        json.dumps({"bos_token_id": config["bos_token_id"], "eos_token_id": config["eos_token_id"]}, indent=2)
    )
    (model_dir / "original" / "params.json").write_text(json.dumps({"vocab_size": cfg.vocab_size}, indent=2))

    tok_path = model_dir / "original" / "tokenizer.model"
    write_tiny_tokenizer(tok_path)
    extend_tiktoken(n_dsus, modality, tok_path, tok_path)
    return model_dir


def synthetic_cpt_rows(n: int, seed: int = 7, n_dsus: int = TINY_N_DSUS) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        n_words = int(rng.integers(8, 20))
        words = [f"w{j}" for j in rng.integers(0, 50, n_words)]
        t = np.cumsum(rng.uniform(0.1, 0.3, n_words))
        rows.append(
            {
                "tokenized": words,
                "align_t_starts": (t - 0.1).tolist(),
                "align_t_ends": t.tolist(),
                "speech_tokens": rng.integers(0, n_dsus, 250).tolist(),
            }
        )
    return rows


def synthetic_sft_rows(n: int, seed: int = 11, n_dsus: int = TINY_N_DSUS) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        n_sp = int(rng.integers(20, 60))
        rows.append(
            {
                "speech_tokens": rng.integers(0, n_dsus, n_sp).tolist(),
                "transcript": " ".join(f"word{j}" for j in rng.integers(0, 40, int(rng.integers(4, 12)))),
                "ID": f"utt_{i}",
            }
        )
    return rows


def base_train_cfg_dict(model_dir: Path, output_dir: Path, kind: str = "sft") -> dict:
    """Composed-config dict for a tiny end-to-end Trainer run (no conf/ files needed)."""
    data_common = {
        "dataloader": {"batch_size": 2, "drop_last": True, "pad_mode": "max_seq_len"},
        "packed": False,
    }
    if kind == "sft":
        dataset = {
            "source": "synthetic/sft",
            "inference": False,
            "deduplicate": True,
            "filter_fn": None,
            "train_on_input": True,
            "column_map": {"input": "speech_tokens", "output": "transcript"},
            "new_system_prompt": "Transcribe. ",
            "use_modality_tokens": True,
            "n_samples": None,
            "split": "train",
        }
    else:
        dataset = {
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
            "add_eos": True,
            "n_samples": None,
        }
    dev_dataset = dict(dataset)
    dev_dataset["split"] = "validation"
    return {
        "config_name": kind,
        "model_config": "tiny_test",
        "speech": {"n_dsus": TINY_N_DSUS, "use_modality_tokens": True, "deduplicate": True},
        "dtype": "fp32",
        "attn_impl": "xla",
        "remat": False,
        "loss_chunk_size": 128,
        "parallel": {"dp": 1, "tp": 1},
        "wandb": {"enabled": False},
        "tokenizer": {"path": str(Path(model_dir) / "original" / "tokenizer.model"), "max_seq_len": 128},
        "optimizer": {
            "lr": 1e-3,
            "betas": [0.9, 0.999],
            "eps": 1e-8,
            "weight_decay": 0.01,
            "mu_dtype": "fp32",
            "nu_dtype": "fp32",
        },
        "lr_scheduler": {"num_warmup_steps": 2, "num_cycles": 0.5},
        "gradient_accumulation_steps": 2,
        "clip_grad_norm": 1.0,
        "max_steps": 8,
        "log_interval": 1,
        "eval_steps": 4,
        "save_steps": 4,
        "force_resume": False,
        "checkpointer": {
            "checkpoint_dir": str(model_dir),
            "checkpoint_files": None,
            "config_json": None,
            "output_dir": str(output_dir),
            "training_state_checkpoint": None,
            "safe_serialization": True,
        },
        "data": {
            "n_dsus": TINY_N_DSUS,
            "train": {"dataset": dataset, "shuffle": True, **data_common},
            "dev": {
                "dataset": dev_dataset,
                "shuffle": False,
                "dataloader": {"batch_size": 2, "drop_last": False, "pad_mode": "max_seq_len"},
                "packed": False,
            },
        },
    }


def make_cfg(data: dict):
    from ssi_jax.config import Config

    return Config(data)


# --- greedy decode oracle -------------------------------------------------------------

_NAIVE_STEP_CACHE: dict = {}


def naive_greedy(params, cfg, prompt: list[int], max_tokens: int, buf_len: int = 64) -> list[int]:
    """Sequential full-recompute greedy decode oracle for engine tests.

    ONE fixed-shape jitted program per (config, padded buffer length) instead
    of a fresh XLA program per sequence length: the token buffer is padded to
    ``buf_len`` and the sampled position is a traced operand
    (dynamic_slice/dynamic_update_slice). Causal masking makes the padded
    positions irrelevant to the sampled row. Besides being much faster across
    a suite that calls this thousands of times, this avoids churning out
    hundreds of tiny CPU executables per test file — a load pattern that
    reliably segfaults this host's libgcc unwinder (stale JIT EH-frame
    entries; SIGSEGV in libgcc_s.so.1 `_Unwind_Backtrace`+FDE lookup during a
    later XLA compile)."""
    import jax
    import jax.numpy as jnp

    from ssi_jax.models.llama3 import forward, logits

    need = len(prompt) + max_tokens
    while buf_len < need:
        buf_len *= 2

    key = (id(cfg), buf_len)
    if key not in _NAIVE_STEP_CACHE:

        def step(params, toks, pos):
            h = forward(params, toks, cfg, attn_impl="xla", remat=False)
            hrow = jax.lax.dynamic_slice_in_dim(h, pos, 1, axis=1)
            t = jnp.argmax(logits(params, hrow)[0, 0]).astype(jnp.int32)
            toks = jax.lax.dynamic_update_slice(toks, t[None, None], (0, pos + 1))
            return t, toks

        _NAIVE_STEP_CACHE[key] = jax.jit(step)
    step = _NAIVE_STEP_CACHE[key]

    buf = np.zeros((1, buf_len), np.int32)
    buf[0, : len(prompt)] = prompt
    import jax.numpy as jnp

    toks = jnp.asarray(buf)
    out = []
    pos = len(prompt) - 1
    for _ in range(max_tokens):
        t, toks = step(params, toks, pos)
        out.append(int(t))
        pos += 1
    return out
