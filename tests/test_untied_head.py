"""Untied output head (``tied_embeddings=False``) and the Llama 3.1 8B entry.

BASELINE's scale stretch names Llama-3-8B (BASELINE.md configs[4]); unlike the
3.2 1B/3B (tied via the reference's TiedLinear, ref:
ssi/extend_llama3_2/__init__.py:102), the 8B checkpoint ships a separate
``lm_head.weight``. These tests pin the untied path end-to-end on the tiny
architecture (init/convert/logits/train/paged decode) plus shape-level compile
checks of the real 8B config, which is too large to materialize in CI.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.checkpoint.convert import expected_hf_keys, hf_to_internal, internal_to_hf
from ssi_jax.models.configs import MODEL_CONFIGS, configllama3_1_8b
from ssi_jax.models.llama3 import forward, init_params, logits, unembed
from tests import helpers


def untied_tiny_config():
    cfg = helpers.tiny_config()
    cfg.tied_embeddings = False
    return cfg


@pytest.fixture(scope="module")
def untied_setup():
    cfg = untied_tiny_config()
    params = init_params(cfg, jax.random.key(11), dtype=jnp.float32)
    return cfg, params


def test_8b_registry_entry():
    cfg = MODEL_CONFIGS["llama3_1_8b"]
    assert cfg is configllama3_1_8b
    assert not cfg.tied_embeddings
    assert (cfg.num_layers, cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads) == (32, 4096, 32, 8)
    assert cfg.intermediate_dim == 14336
    assert cfg.vocab_size == 128_000 + 256  # base; DSU arithmetic same as 1B/3B
    ext = cfg.copy()
    ext.n_dsus = 5000
    ext.modality_tokens = True
    assert ext.vocab_size == 128_000 + 256 + 5000 + 2
    exp = cfg.checkpoint_expectations
    assert exp.model_name == "Llama 3.1 8B"
    assert exp.n_shards == 4
    assert "lm_head.weight" in expected_hf_keys(cfg)


def test_untied_init_and_logits(untied_setup):
    cfg, params = untied_setup
    assert "lm_head" in params
    assert params["lm_head"].shape == params["embed"].shape
    assert unembed(params) is params["lm_head"]

    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)), jnp.int32)
    hidden = forward(params, tokens, cfg, attn_impl="xla", remat=False)
    # logits must come from lm_head: zeroing it zeroes the logits while the
    # embedding (and therefore hidden) stays nonzero
    zeroed = dict(params, lm_head=jnp.zeros_like(params["lm_head"]))
    assert np.all(np.asarray(logits(zeroed, hidden)) == 0.0)
    assert np.any(np.asarray(logits(params, hidden)) != 0.0)


def test_untied_hf_roundtrip(untied_setup):
    cfg, params = untied_setup
    hf = internal_to_hf(jax.device_get(params), cfg, xp=np)
    assert set(hf.keys()) == expected_hf_keys(cfg)
    assert "lm_head.weight" in hf
    back = hf_to_internal(hf, cfg, xp=np)
    np.testing.assert_array_equal(np.asarray(back["lm_head"]), np.asarray(params["lm_head"]))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # an untied checkpoint missing its head must be rejected, not silently tied
    hf_missing = {k: v for k, v in hf.items() if k != "lm_head.weight"}
    with pytest.raises(KeyError, match="lm_head"):
        hf_to_internal(hf_missing, cfg, xp=np)


def test_untied_logits_match_transformers(untied_setup):
    torch = pytest.importorskip("torch")
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg, params = untied_setup
    hf_state = internal_to_hf(jax.device_get(params), cfg, xp=np)

    hf_cfg = LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.embed_dim,
        intermediate_size=cfg.intermediate_dim,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        rms_norm_eps=cfg.norm_eps,
        rope_theta=float(cfg.rope_base),
        rope_scaling={
            "rope_type": "llama3",
            "factor": float(cfg.scale_factor),
            "low_freq_factor": cfg.rope_low_freq_factor,
            "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_original_max_seq_len,
        },
        tie_word_embeddings=False,
        attention_bias=False,
        mlp_bias=False,
        max_position_embeddings=cfg.max_seq_len,
    )
    model = LlamaForCausalLM(hf_cfg)
    sd = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in hf_state.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all("rotary" in k for k in missing), missing  # untied: lm_head must load
    model.eval()

    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with torch.no_grad():
        ref_logits = model(torch.from_numpy(tokens).long()).logits.numpy()
    hidden = forward(params, jnp.asarray(tokens), cfg, attn_impl="xla", remat=False)
    np.testing.assert_allclose(np.asarray(logits(params, hidden)), ref_logits, rtol=2e-4, atol=2e-4)


def test_untied_train_step_updates_lm_head(untied_setup):
    from ssi_jax.train.lr_schedule import constant_schedule
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    cfg, params = untied_setup
    opt_cfg = AdamWConfig(lr=1e-3, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
    step = make_train_step(
        cfg, opt_cfg, constant_schedule(1e-3), attn_impl="xla", remat=False,
        chunk_size=64, donate=False,
    )
    state = {"params": params, "opt_state": init_opt_state(params, opt_cfg), "step": jnp.zeros((), jnp.int32)}

    rng = np.random.default_rng(2)
    tokens = jnp.asarray(rng.integers(4, cfg.vocab_size, (1, 2, 16)), jnp.int32)
    new_state, metrics = step(state, tokens, tokens)

    assert float(metrics["loss_sum"]) > 0.0
    # both the head (CE weight) and the embedding (input side) must move, and
    # independently — tied behaviour would keep them bit-identical
    assert not np.array_equal(np.asarray(new_state["params"]["lm_head"]), np.asarray(params["lm_head"]))
    assert not np.array_equal(np.asarray(new_state["params"]["embed"]), np.asarray(params["embed"]))
    assert not np.array_equal(
        np.asarray(new_state["params"]["lm_head"]), np.asarray(new_state["params"]["embed"])
    )


def test_untied_paged_decode_greedy_parity(untied_setup):
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine

    cfg, params = untied_setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())
    eng = PagedDecodeEngine(
        params, cfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8,
        max_context=64, chunk=4, attn_impl="gather",
    )
    outs = eng.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == helpers.naive_greedy(params, cfg, prompt, 5)


def test_8b_compile_check():
    """Shape-level trace of init + loss + one optimizer step on the REAL 8B
    config (abstract arrays only — nothing materializes)."""
    from ssi_jax.train.lr_schedule import constant_schedule
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    cfg = configllama3_1_8b.copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True

    shapes = jax.eval_shape(lambda k: init_params(cfg, k), jax.random.key(0))
    assert shapes["lm_head"].shape == (cfg.vocab_size, 4096)
    assert shapes["embed"].shape == (cfg.vocab_size, 4096)
    assert shapes["layers"]["wq"].shape == (32, 4096, 4096)
    assert shapes["layers"]["wk"].shape == (32, 4096, 1024)  # 8 KV heads x 128
    assert shapes["layers"]["w_gate"].shape == (32, 4096, 14336)

    opt_cfg = AdamWConfig(lr=1e-4)
    step = make_train_step(
        cfg, opt_cfg, constant_schedule(1e-4), attn_impl="xla", chunk_size=2048, donate=False,
    )
    tok = jax.ShapeDtypeStruct((1, 2, 512), jnp.int32)

    def build(k):
        p = init_params(cfg, k)
        return {"params": p, "opt_state": init_opt_state(p, opt_cfg), "step": jnp.zeros((), jnp.int32)}

    state_shapes = jax.eval_shape(build, jax.random.key(0))
    out_state, metrics = jax.eval_shape(step, state_shapes, tok, tok)
    assert out_state["params"]["lm_head"].shape == (cfg.vocab_size, 4096)
    assert metrics["loss_sum"].shape == ()
