"""Op-level correctness: fused cross-entropy (fwd + custom VJP) and attention."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_jax.ops.attention import xla_attention
from ssi_jax.ops.cross_entropy import cross_entropy_sum_and_count, fused_cross_entropy


def naive_ce_sum(hidden, embed, labels):
    logits = hidden @ embed.T
    valid = labels != CROSS_ENTROPY_IGNORE_IDX
    safe = jnp.where(valid, labels, 0)
    lse = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, safe[:, None], axis=-1)[:, 0]
    return jnp.sum(jnp.where(valid, lse - picked, 0.0))


@pytest.mark.parametrize("n,v,chunk", [(64, 50, 16), (100, 37, 32), (7, 13, 16)])
def test_fused_ce_forward_matches_naive(n, v, chunk):
    rng = np.random.default_rng(0)
    hidden = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
    embed = jnp.asarray(rng.standard_normal((v, 8)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, v, n), jnp.int32)
    labels = labels.at[::5].set(CROSS_ENTROPY_IGNORE_IDX)

    fused = fused_cross_entropy(hidden, embed, labels, chunk)
    naive = naive_ce_sum(hidden, embed, labels)
    np.testing.assert_allclose(float(fused), float(naive), rtol=1e-5)

    _, count = cross_entropy_sum_and_count(hidden, embed, labels, chunk)
    assert int(count) == int(jnp.sum(labels != CROSS_ENTROPY_IGNORE_IDX))


def test_fused_ce_gradients_match_naive():
    rng = np.random.default_rng(1)
    hidden = jnp.asarray(rng.standard_normal((48, 8)), jnp.float32)
    embed = jnp.asarray(rng.standard_normal((30, 8)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 30, 48), jnp.int32).at[::7].set(CROSS_ENTROPY_IGNORE_IDX)

    g_fused = jax.grad(lambda h, e: fused_cross_entropy(h, e, labels, 16), argnums=(0, 1))(hidden, embed)
    g_naive = jax.grad(lambda h, e: naive_ce_sum(h, e, labels), argnums=(0, 1))(hidden, embed)
    np.testing.assert_allclose(np.asarray(g_fused[0]), np.asarray(g_naive[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_fused[1]), np.asarray(g_naive[1]), rtol=1e-4, atol=1e-5)


def test_fused_ce_all_ignored_is_zero():
    hidden = jnp.ones((8, 4), jnp.float32)
    embed = jnp.ones((10, 4), jnp.float32)
    labels = jnp.full((8,), CROSS_ENTROPY_IGNORE_IDX, jnp.int32)
    assert float(fused_cross_entropy(hidden, embed, labels, 8)) == 0.0
    g = jax.grad(lambda h: fused_cross_entropy(h, embed, labels, 8))(hidden)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def naive_attention(q, k, v, causal=True):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    k = np.repeat(k, rep, axis=2)
    v = np.repeat(v, rep, axis=2)
    out = np.zeros_like(q)
    for bi in range(b):
        for h in range(hq):
            scores = q[bi, :, h] @ k[bi, :, h].T / np.sqrt(d)
            if causal:
                mask = np.tril(np.ones((s, s), bool))
                scores = np.where(mask, scores, -np.inf)
            w = np.exp(scores - scores.max(-1, keepdims=True))
            w /= w.sum(-1, keepdims=True)
            out[bi, :, h] = w @ v[bi, :, h]
    return out


def test_xla_attention_matches_naive_gqa():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    ours = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    ref = naive_attention(q, k, v, causal=True)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_adamw_matches_torch():
    """First-party AdamW vs torch.optim.AdamW over several steps."""
    torch = pytest.importorskip("torch")
    from ssi_jax.train.optimizer import AdamWConfig, adamw_update, init_opt_state

    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(5)]

    # torch
    wt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.AdamW([wt], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for g in grads:
        wt.grad = torch.from_numpy(g.copy())
        opt.step()

    # ours
    cfg = AdamWConfig(lr=1e-2, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
    params = {"w": jnp.asarray(w0)}
    state = init_opt_state(params, cfg)
    for g in grads:
        params, state = adamw_update({"w": jnp.asarray(g)}, state, params, jnp.float32(1e-2), cfg)

    np.testing.assert_allclose(np.asarray(params["w"]), wt.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm_matches_torch_semantics():
    from ssi_jax.train.optimizer import clip_by_global_norm, global_norm

    tree = {"a": jnp.asarray([3.0, 4.0])}  # norm 5
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(5.0)
    np.testing.assert_allclose(np.asarray(clipped["a"]), np.asarray([0.6, 0.8]), rtol=1e-5)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    # below max_norm: unchanged
    small, norm2 = clip_by_global_norm({"a": jnp.asarray([0.3, 0.4])}, 1.0)
    np.testing.assert_allclose(np.asarray(small["a"]), np.asarray([0.3, 0.4]), rtol=1e-6)


def test_stochastic_rounding_preserves_small_updates():
    """bf16 moments with RTN freeze when updates are below the bf16 ulp; stochastic
    rounding keeps the expected value moving (ROADMAP quality item)."""
    from ssi_jax.train.optimizer import AdamWConfig, adamw_update, init_opt_state

    # nu update per step is (1-b2)*g^2 = 1e-3 * 1.0; against a stored nu of 1.0
    # that's ~1/4 of the bf16 ulp (2^-8) -> RTN drops it every step.
    def run(stochastic, steps=400):
        cfg = AdamWConfig(lr=0.0, b2=0.999, weight_decay=0.0, mu_dtype=jnp.float32,
                          nu_dtype=jnp.bfloat16, stochastic_rounding=stochastic)
        params = {"w": jnp.ones((128,), jnp.float32)}
        state = init_opt_state(params, cfg)
        state["nu"]["w"] = jnp.ones((128,), jnp.bfloat16)  # start at 1.0 so decay ~ feed
        g = {"w": jnp.ones((128,), jnp.float32)}
        for _ in range(steps):
            params, state = adamw_update(g, state, params, jnp.float32(0.0), cfg)
        return float(jnp.mean(state["nu"]["w"].astype(jnp.float32)))

    # exact fp32 trajectory: nu stays at 1.0 (decay exactly balanced by the g^2 feed)
    rtn = run(False)
    sto = run(True)
    # RTN: decay term 0.999*1.0 rounds back to 1.0 and the 1e-3 feed is lost -> stuck
    # exactly at 1.0 OR collapses depending on rounding direction; stochastic stays
    # near 1.0 in expectation. The discriminating check: stochastic must not be
    # further from the true value than RTN, and must show movement (not bit-frozen).
    assert abs(sto - 1.0) <= abs(rtn - 1.0) + 0.02
    # determinism: same steps -> same result (rounding keys derive from the counter)
    assert run(True) == run(True)
