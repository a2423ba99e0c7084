"""Decode engine correctness + generation pipeline contract."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.generate.engine import DecodeEngine, SamplingParams
from ssi_jax.models.llama3 import forward, init_params, logits
from tests import helpers


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, params


naive_greedy = helpers.naive_greedy  # fixed-shape oracle (see helpers docstring)


def test_greedy_matches_naive_full_recompute(setup):
    cfg, params = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    engine = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        expected = naive_greedy(params, cfg, prompt, 6)
        assert out["token_ids"] == expected, f"{out['token_ids']} != {expected}"
        assert out["finish_reason"] == "length"
        assert out["stop_reason"] is None


def test_stop_tokens_halt_generation(setup):
    cfg, params = setup
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    first = naive_greedy(params, cfg, prompt, 1)[0]
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=(first,))
    engine = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    out = engine.generate_batch([prompt], sp)[0]
    assert out["token_ids"] == [first]
    assert out["finish_reason"] == "stop"
    assert out["stop_reason"] == first


def test_batch_isolation(setup):
    """A row's output is independent of what else is in the batch."""
    cfg, params = setup
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, cfg.vocab_size, 7).tolist()
    p2 = rng.integers(0, cfg.vocab_size, 13).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())
    engine = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    solo = engine.generate_batch([p2, p2], sp)[0]
    mixed = [r for r in engine.generate_batch([p1, p2], sp)]
    assert mixed[1]["token_ids"] == solo["token_ids"]


def test_top_k_at_or_above_vocab_is_disabled(setup):
    """top_k >= vocab_size means "disabled" (vLLM semantics), not an
    out-of-bounds sort index at trace time."""
    cfg, params = setup
    prompt = list(range(8))
    engine = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    big = SamplingParams(temperature=0.8, top_k=cfg.vocab_size + 5, top_p=1.0, max_tokens=4, stop_token_ids=())
    off = SamplingParams(temperature=0.8, top_k=-1, top_p=1.0, max_tokens=4, stop_token_ids=())
    a = engine.generate_batch([prompt], big, key=jax.random.key(3))[0]
    b = engine.generate_batch([prompt], off, key=jax.random.key(3))[0]
    assert a["token_ids"] == b["token_ids"]


def test_temperature_sampling_reproducible(setup):
    cfg, params = setup
    prompt = list(range(10))
    sp = SamplingParams(temperature=0.8, top_k=10, top_p=0.95, max_tokens=5, stop_token_ids=())
    engine = DecodeEngine(params, cfg, pad_id=0, prompt_bucket=8)
    a = engine.generate_batch([prompt], sp, key=jax.random.key(1))[0]
    b = engine.generate_batch([prompt], sp, key=jax.random.key(1))[0]
    c = engine.generate_batch([prompt], sp, key=jax.random.key(2))[0]
    assert a["token_ids"] == b["token_ids"]
    assert all(0 <= t < cfg.vocab_size for t in a["token_ids"])
    assert isinstance(c["token_ids"], list)


def test_run_generation_end_to_end(tmp_path, synthetic_data):
    """Full generate flow: step dir -> generations.jsonl consumable by the WER tools."""
    from ssi_jax.config import Config
    from ssi_jax.generate import run_generation
    from ssi_jax.utils import extract_texts_from_generations_jsonl

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = Config(
        {
            "config_name": "generate",
            "model_config": "tiny_test",
            "speech": {"n_dsus": helpers.TINY_N_DSUS, "use_modality_tokens": True, "deduplicate": True},
            "dtype": "fp32",
            "model": str(model_dir),
            "experiments_root_dir": str(tmp_path),
            "tokenizer": {"path": str(model_dir / "original" / "tokenizer.model"), "max_seq_len": None},
            "gen": {
                "output_dir": str(tmp_path / "gens"),
                "output_filename": "generations.jsonl",
                "output_config_filename": "generation_config.yaml",
                "use_cfg_hash_subdir": False,
                "split": "test",
            },
            "batch_size": 4,
            "tokenizer_decoding": {"truncate_at_eos": True, "skip_special_tokens": True},
            "sampling_params": {
                "stop_token_ids": None,
                "n": 1,
                "temperature": 0.0,
                "top_p": 1,
                "max_tokens": 8,
                "top_k": -1,
            },
            "observability": True,
            "data": {
                "n_dsus": helpers.TINY_N_DSUS,
                "test": {
                    "dataset": {
                        "source": "synthetic/sft",
                        "inference": True,
                        "deduplicate": True,
                        "filter_fn": None,
                        "train_on_input": True,
                        "column_map": {"input": "speech_tokens", "output": "transcript"},
                        "new_system_prompt": "Transcribe. ",
                        "use_modality_tokens": True,
                        "n_samples": 6,
                        "split": "test",
                    },
                },
            },
        }
    )
    out_dir = run_generation(cfg)
    gen_file = out_dir / "generations.jsonl"
    assert gen_file.is_file()
    records = [json.loads(line) for line in gen_file.read_text().splitlines()]
    assert len(records) == 6
    for rec in records:
        assert rec["finished"] is True
        assert len(rec["outputs"]) == 1
        out = rec["outputs"][0]
        assert isinstance(out["text"], str)
        assert out["finish_reason"] in ("stop", "length")
        assert "metrics" in rec  # observability on
        assert isinstance(rec["prompt_token_ids"], list) and rec["prompt_token_ids"]
    # consumable by the WER extraction helper (single generation per prompt)
    texts = extract_texts_from_generations_jsonl(gen_file)
    assert len(texts) == 6
    # config snapshot written; second run refuses to overwrite
    assert (out_dir / "generation_config.yaml").is_file()
    with pytest.raises(FileExistsError):
        run_generation(cfg)

    # n>1 parallel sampling: one record per prompt, n entries in outputs
    # (vLLM record shape); greedy -> all sequences identical to the n=1 run
    cfg.gen.output_dir = str(tmp_path / "gens_n3")
    cfg.sampling_params.n = 3
    out_dir3 = run_generation(cfg)
    records3 = [json.loads(line) for line in (out_dir3 / "generations.jsonl").read_text().splitlines()]
    assert len(records3) == 6
    for rec1, rec3 in zip(records, records3):
        assert len(rec3["outputs"]) == 3
        assert [o["index"] for o in rec3["outputs"]] == [0, 1, 2]
        for o in rec3["outputs"]:
            assert o["token_ids"] == rec1["outputs"][0]["token_ids"]


def test_render_templates():
    from ssi_jax.generate.templates import list_templates, render_template
    from ssi_jax.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

    names = list_templates()
    assert {"basic", "capital_of_france", "empty", "raven_poe", "repeat_this_modality_switch"} <= set(names)
    out = render_template("repeat_this_modality_switch", speech_tokens=[1, 1, 2], deduplicate=True)
    assert out == f"Repeat the following: {MODALITY_TOKEN_SPEECH}{dsu2pua(1)}{dsu2pua(2)}{MODALITY_TOKEN_TEXT}\n"
    assert render_template("empty") == ""
    assert render_template("capital_of_france_text_modality_token") == f"The capital of France is{MODALITY_TOKEN_TEXT}"
    # missing variable -> StrictUndefined error
    import jinja2, pytest as _pytest
    with _pytest.raises(jinja2.exceptions.UndefinedError):
        render_template("basic")


def test_run_generation_int8_config_path(tmp_path, synthetic_data):
    """quantize_weights: int8 flows from the config into the paged engine and
    the flow still produces schema-valid generations."""
    import copy

    from ssi_jax.config import Config
    from ssi_jax.generate import run_generation

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    cfg = Config(
        {
            "config_name": "generate",
            "model_config": "tiny_test",
            "speech": {"n_dsus": helpers.TINY_N_DSUS, "use_modality_tokens": True, "deduplicate": True},
            "dtype": "fp32",
            "model": str(model_dir),
            "experiments_root_dir": str(tmp_path),
            "tokenizer": {"path": str(model_dir / "original" / "tokenizer.model"), "max_seq_len": None},
            "gen": {
                "output_dir": str(tmp_path / "gens_int8"),
                "output_filename": "generations.jsonl",
                "output_config_filename": "generation_config.yaml",
                "use_cfg_hash_subdir": False,
                "split": "test",
            },
            "batch_size": 2,
            "engine": "paged",
            "quantize_weights": "int8",
            "tokenizer_decoding": {"truncate_at_eos": True, "skip_special_tokens": True},
            "sampling_params": {
                "stop_token_ids": None, "n": 1, "temperature": 0.0,
                "top_p": 1, "max_tokens": 4, "top_k": -1,
            },
            "observability": False,
            "data": {
                "n_dsus": helpers.TINY_N_DSUS,
                "test": {
                    "dataset": {
                        "source": "synthetic/sft", "inference": True, "deduplicate": True,
                        "filter_fn": None, "train_on_input": True,
                        "column_map": {"input": "speech_tokens", "output": "transcript"},
                        "new_system_prompt": "Transcribe. ", "use_modality_tokens": True,
                        "n_samples": 3, "split": "test",
                    },
                },
            },
        }
    )
    out_dir = run_generation(cfg)
    records = [json.loads(l) for l in (out_dir / "generations.jsonl").read_text().splitlines()]
    assert len(records) == 3
    # default stop set is active and the quantized tiny model may emit a stop
    assert all(1 <= len(r["outputs"][0]["token_ids"]) <= 4 for r in records)


def test_run_generation_speculative_config_path(tmp_path, synthetic_data):
    """speculate_k flows from the config into the paged engine and the
    end-to-end generations are byte-identical to the non-speculative run
    (lossless greedy speculation)."""
    import copy

    from ssi_jax.config import Config
    from ssi_jax.generate import run_generation

    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    base = {
        "config_name": "generate",
        "model_config": "tiny_test",
        "speech": {"n_dsus": helpers.TINY_N_DSUS, "use_modality_tokens": True, "deduplicate": True},
        "dtype": "fp32",
        "model": str(model_dir),
        "experiments_root_dir": str(tmp_path),
        "tokenizer": {"path": str(model_dir / "original" / "tokenizer.model"), "max_seq_len": None},
        "gen": {
            "output_dir": None,
            "output_filename": "generations.jsonl",
            "output_config_filename": "generation_config.yaml",
            "use_cfg_hash_subdir": False,
            "split": "test",
        },
        "batch_size": 2,
        "engine": "paged",
        "tokenizer_decoding": {"truncate_at_eos": True, "skip_special_tokens": True},
        "sampling_params": {
            "stop_token_ids": None, "n": 1, "temperature": 0.0,
            "top_p": 1, "max_tokens": 6, "top_k": -1,
        },
        "observability": False,
        "data": {
            "n_dsus": helpers.TINY_N_DSUS,
            "test": {
                "dataset": {
                    "source": "synthetic/sft", "inference": True, "deduplicate": True,
                    "filter_fn": None, "train_on_input": True,
                    "column_map": {"input": "speech_tokens", "output": "transcript"},
                    "new_system_prompt": "Transcribe. ", "use_modality_tokens": True,
                    "n_samples": 3, "split": "test",
                },
            },
        },
    }
    runs = {}
    for k in (0, 3):
        cfg_d = copy.deepcopy(base)
        cfg_d["gen"]["output_dir"] = str(tmp_path / f"gens_spec{k}")
        cfg_d["speculate_k"] = k
        out_dir = run_generation(Config(cfg_d))
        runs[k] = [json.loads(l) for l in (out_dir / "generations.jsonl").read_text().splitlines()]
    assert len(runs[0]) == 3
    for r0, r3 in zip(runs[0], runs[3]):
        assert r0["outputs"][0]["token_ids"] == r3["outputs"][0]["token_ids"]
        assert r0["outputs"][0]["text"] == r3["outputs"][0]["text"]
