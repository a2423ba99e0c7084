"""Attention backends: the cuDNN wrapper's argument construction, backend
resolution per platform, and the compile-cache location.

The cuDNN wrapper is checked on the CPU by driving the same call through JAX's
own XLA implementation of ``jax.nn.dot_product_attention``; the ``gpu``-marked
test runs cuDNN itself.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ssi_jax
from ssi_jax.ops.attention import cudnn_attention, dispatch_attention, resolve_attn_impl, segment_mask, xla_attention


def _qkv(b, s, hq, hkv, d, seed=0, dtype=jnp.float32):
    ks = jax.random.split(jax.random.key(seed), 3)
    return (jax.random.normal(ks[0], (b, s, hq, d), dtype), jax.random.normal(ks[1], (b, s, hkv, d), dtype),
            jax.random.normal(ks[2], (b, s, hkv, d), dtype))


def _segments(b, s, seed=0):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, s), (b, 2), replace=False), axis=1)
    return jnp.asarray((np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1) + 1, jnp.int32)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_wrapper_matches_reference_fwd_and_grads(hq, hkv, packed):
    q, k, v = _qkv(2, 32, hq, hkv, 16)
    seg = _segments(2, 32) if packed else None

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, causal=True, segment_ids=seg) ** 2)

    wrapped = lambda *a, **kw: cudnn_attention(*a, **kw, implementation="xla")  # noqa: E731
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(wrapped(q, k, v, causal=True, segment_ids=seg),
                                   xla_attention(q, k, v, causal=True, segment_ids=seg), rtol=1e-5, atol=1e-5)
        g_got = jax.grad(lambda *a: loss(wrapped, *a), argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(lambda *a: loss(xla_attention, *a), argnums=(0, 1, 2))(q, k, v)
    for got, ref in zip(g_got, g_ref):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_segment_mask_shape_and_blocks():
    seg = jnp.asarray([[1, 1, 2, 2, 0]], jnp.int32)
    m = np.asarray(segment_mask(seg))
    assert m.shape == (1, 1, 5, 5)
    assert m[0, 0, 0, 1] and not m[0, 0, 1, 2] and m[0, 0, 2, 3] and m[0, 0, 4, 4]


@pytest.mark.parametrize(
    "impl,platform,dtype,want",
    [
        ("auto", "gpu", jnp.bfloat16, "cudnn"),
        ("auto", "gpu", jnp.float16, "cudnn"),
        ("auto", "gpu", jnp.float32, "xla"),  # cuDNN takes bf16/fp16 only
        ("auto", "cpu", jnp.bfloat16, "xla"),
        ("auto", "cpu", jnp.float32, "xla"),
        ("xla", "gpu", jnp.bfloat16, "xla"),
        ("cudnn", "cpu", jnp.bfloat16, "cudnn"),
    ],
)
def test_resolve_attn_impl(impl, platform, dtype, want):
    assert resolve_attn_impl(impl, dtype, platform) == want


@pytest.mark.parametrize("impl,platform", [("pallas", "gpu"), ("pallas_grouped", "cpu"), ("auto", "rocm")])
def test_resolve_attn_impl_rejects(impl, platform):
    with pytest.raises(ValueError):
        resolve_attn_impl(impl, jnp.bfloat16, platform)


def test_float32_auto_train_step_runs_reference(monkeypatch):
    """A float32 train step with ``attn_impl="auto"`` on a GPU runs the einsum
    path: its trace calls ``xla_attention`` and never ``cudnn_attention``."""
    from ssi_jax.models.configs import config_tiny_test
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.train.lr_schedule import constant_schedule
    from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
    from ssi_jax.train.step import make_train_step

    attention = importlib.import_module("ssi_jax.ops.attention")  # the module, not the jitted function
    monkeypatch.setitem(attention._AUTO_ATTN, "cpu", "cudnn")  # make this CPU resolve like a GPU
    called = []
    monkeypatch.setattr(attention, "cudnn_attention", lambda *a, **kw: called.append("cudnn"))
    ref = attention.xla_attention
    monkeypatch.setattr(attention, "xla_attention", lambda *a, **kw: called.append("xla") or ref(*a, **kw))
    params = init_params(config_tiny_test, jax.random.key(0), jnp.float32)
    opt = AdamWConfig(mu_dtype=jnp.float32, nu_dtype=jnp.float32)
    state = {"params": params, "opt_state": init_opt_state(params, opt), "step": jnp.zeros((), jnp.int32)}
    step = make_train_step(config_tiny_test, opt, constant_schedule(1e-3), attn_impl="auto", remat=False)
    toks = jnp.ones((1, 2, 16), jnp.int32)
    _, m = step(state, toks, toks)
    assert set(called) == {"xla"} and np.isfinite(float(m["loss_sum"]))


def test_dispatch_auto_is_reference_on_cpu():
    q, k, v = _qkv(1, 16, 4, 2, 8)
    np.testing.assert_array_equal(dispatch_attention(q, k, v, impl="auto"), xla_attention(q, k, v))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = "import jax, ssi_jax; print(ssi_jax.compile_cache_dir()); print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, check=True,
                         cwd=ssi_jax.REPO_ROOT).stdout.split()
    want = str(tmp_path / env_dir) if env_dir else os.path.join(ssi_jax.REPO_ROOT, ".jax_cache")
    assert out == [want, want]


@pytest.mark.gpu
def test_cudnn_on_card_matches_reference(gpu_device):
    q, k, v = _qkv(4, 768, 32, 8, 64, dtype=jnp.bfloat16)
    seg = _segments(4, 768)
    got = cudnn_attention(q, k, v, causal=True, segment_ids=seg)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        ref = xla_attention(f32(q), f32(k), f32(v), causal=True, segment_ids=seg)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - ref)) / jnp.max(jnp.abs(ref)))
    assert err <= 1e-2, err
