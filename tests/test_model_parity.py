"""Forward-pass parity vs Hugging Face transformers (torch CPU).

The strongest correctness check available without the real 1B weights: identical
random weights loaded into (a) our stacked JAX decoder and (b) transformers'
LlamaForCausalLM with the same architecture + llama3 RoPE scaling must produce
matching logits. Replaces the reference's reliance on torchtune's tested model
implementation (ref: ssi/model.py:18-39).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.checkpoint.convert import expected_hf_keys, hf_to_internal, internal_to_hf
from ssi_jax.models.llama3 import forward, forward_slots, init_kv_cache, init_params, logits
from tests import helpers


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(42), dtype=jnp.float32)
    return cfg, params


def test_hf_convert_roundtrip(tiny_setup):
    cfg, params = tiny_setup
    hf = internal_to_hf(jax.device_get(params), cfg, xp=np)
    assert set(hf.keys()) == expected_hf_keys(cfg)
    back = hf_to_internal(hf, cfg, xp=np)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_logits_match_transformers(tiny_setup):
    torch = pytest.importorskip("torch")
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg, params = tiny_setup
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
        tie_word_embeddings=True,
        attention_bias=False,
        mlp_bias=False,
        max_position_embeddings=cfg.max_seq_len,
    )
    model = LlamaForCausalLM(hf_cfg)
    sd = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in hf_state.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all("lm_head" in k or "rotary" in k for k in missing), missing  # tied head + rope buffers
    model.eval()

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)

    with torch.no_grad():
        ref_logits = model(torch.from_numpy(tokens).long()).logits.numpy()

    hidden = forward(params, jnp.asarray(tokens), cfg, attn_impl="xla", remat=False)
    ours = np.asarray(logits(params, hidden))

    np.testing.assert_allclose(ours, ref_logits, rtol=2e-4, atol=2e-4)


def test_kv_cache_decode_matches_full_forward(tiny_setup):
    """Prefill+decode through the canonical cache path must equal the full forward."""
    cfg, params = tiny_setup
    rng = np.random.default_rng(1)
    b, prompt_len, extra = 2, 12, 4
    tokens = rng.integers(0, cfg.vocab_size, (b, prompt_len + extra)).astype(np.int32)

    full_hidden = forward(params, jnp.asarray(tokens), cfg, attn_impl="xla", remat=False)
    full_logits = np.asarray(logits(params, full_hidden))

    cache = {k: v[:, :, :32] for k, v in init_kv_cache(cfg, b, max_len=32, dtype=jnp.float32).items()}
    offsets = jnp.zeros((b,), jnp.int32)  # no left padding
    hidden, cache = forward_slots(params, jnp.asarray(tokens[:, :prompt_len]), cfg, cache, jnp.int32(0), offsets, prompt_len)
    step_logits = [np.asarray(logits(params, hidden[:, -1:, :]))]
    for t in range(extra):
        hidden, cache = forward_slots(
            params, jnp.asarray(tokens[:, prompt_len + t : prompt_len + t + 1]), cfg, cache,
            jnp.int32(prompt_len + t), offsets, 1,
        )
        step_logits.append(np.asarray(logits(params, hidden)))

    # logits at positions prompt_len-1 .. prompt_len+extra-1
    stacked = np.concatenate(step_logits, axis=1)
    np.testing.assert_allclose(stacked, full_logits[:, prompt_len - 1 :, :], rtol=1e-4, atol=1e-4)

    # left-padded variant: same decode through pad offsets must match the unpadded one
    pad = 6
    padded = np.concatenate([np.zeros((b, pad), np.int32), tokens[:, :prompt_len]], axis=1)
    cache2 = {k: v[:, :, : 32 + pad] for k, v in init_kv_cache(cfg, b, max_len=32 + pad, dtype=jnp.float32).items()}
    offs = jnp.full((b,), pad, jnp.int32)
    hidden2, _ = forward_slots(params, jnp.asarray(padded), cfg, cache2, jnp.int32(0), offs, prompt_len + pad)
    np.testing.assert_allclose(
        np.asarray(logits(params, hidden2[:, -1:, :])), step_logits[0], rtol=1e-4, atol=1e-4
    )


def test_segment_ids_isolate_packed_sequences(tiny_setup):
    """Packed-attention masking: two segments in one row attend independently."""
    cfg, params = tiny_setup
    rng = np.random.default_rng(2)
    a = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)

    packed = jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], axis=1)
    seg = jnp.concatenate([jnp.ones((1, 8), jnp.int32), jnp.full((1, 8), 2, jnp.int32)], axis=1)
    positions = jnp.concatenate([jnp.arange(8), jnp.arange(8)])[None, :].astype(jnp.int32)
    packed_h = forward(params, packed, cfg, positions=positions, segment_ids=seg, attn_impl="xla", remat=False)

    solo_h = forward(params, jnp.asarray(b), cfg, attn_impl="xla", remat=False)
    np.testing.assert_allclose(np.asarray(packed_h[:, 8:, :]), np.asarray(solo_h), rtol=1e-4, atol=1e-4)
