"""Triton paged decode kernel (generate/paged_triton.py) against the XLA gather path.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``); the
``gpu``-marked tests compile it for the card.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.generate import paged_triton
from ssi_jax.generate.paged import decode_attention_fn, paged_attention, resolve_decode_impl
from ssi_jax.generate.paged_triton import paged_attention_triton


def _case(n_rep, ps, dtype, lens, hkv=2, hd=16, max_pages=4, seed=0):
    rng = np.random.default_rng(seed)
    n_slots = len(lens)
    rows = 2 * n_slots * max_pages + 1
    kp = jnp.asarray(rng.standard_normal((rows, ps, hkv * hd)), dtype)
    vp = jnp.asarray(rng.standard_normal((rows, ps, hkv * hd)), dtype)
    q = jnp.asarray(rng.standard_normal((n_slots, hkv * n_rep, hd)), dtype)
    table = jnp.asarray(rng.permutation(rows - 1)[: n_slots * max_pages].reshape(n_slots, max_pages), jnp.int32)
    return q, kp, vp, table, jnp.asarray(lens, jnp.int32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_kernel_matches_gather_interpret(n_rep, ps, dtype):
    """Ragged lengths: 1 token, exactly one page, a full max_pages window, a
    mid-page length."""
    max_pages = 4
    lens = [1, ps, max_pages * ps, ps + 3]
    q, kp, vp, table, lens = _case(n_rep, ps, dtype, lens, max_pages=max_pages)
    got = paged_attention_triton(q, kp, vp, table, lens, interpret=True)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        ref = paged_attention(f32(q), f32(kp), f32(vp), table, lens)
    assert got.shape == q.shape and got.dtype == q.dtype
    # float32: same math, other summation order; bf16: rounding of p and the output
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref), rtol=tol, atol=tol)


def test_zero_length_slot_reads_nothing():
    """An inactive slot (length 0) gets zeros, not NaN from an empty softmax."""
    q, kp, vp, table, lens = _case(4, 16, jnp.float32, [0, 5])
    got = np.asarray(paged_attention_triton(q, kp, vp, table, lens, interpret=True))
    assert np.all(got[0] == 0.0) and np.isfinite(got).all()


@pytest.mark.parametrize("ps,hd", [(8, 16), (24, 16), (16, 8)])
def test_rejects_non_power_of_two_blocks(ps, hd):
    q, kp, vp, table, lens = _case(1, ps, jnp.float32, [1, 2], hd=hd)
    with pytest.raises(ValueError, match="power-of-two"):
        paged_attention_triton(q, kp, vp, table, lens, interpret=True)


def test_engine_decodes_through_the_kernel(monkeypatch):
    """The engine's ``"triton"`` decode path (kernel in interpret mode) emits the
    same greedy tokens as the gather path."""
    from ssi_jax.generate.engine import SamplingParams
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.llama3 import init_params
    from tests import helpers

    monkeypatch.setattr(paged_triton, "paged_attention_triton",
                        functools.partial(paged_triton.paged_attention_triton, interpret=True))
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 17, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())
    kw = dict(n_slots=4, page_size=16, prompt_bucket=16, max_context=64, chunk=4)
    want = PagedDecodeEngine(params, cfg, pad_id=0, attn_impl="gather", **kw).generate_batch(prompts, sp)
    engine = PagedDecodeEngine(params, cfg, pad_id=0, attn_impl="triton", **kw)
    assert engine.attn_impl == "triton"
    got = engine.generate_batch(prompts, sp)
    assert [o["token_ids"] for o in got] == [o["token_ids"] for o in want]


@pytest.mark.parametrize(
    "impl,platform,want",
    [("auto", "gpu", "triton"), ("auto", "cpu", "gather"), ("gather", "gpu", "gather"), ("triton", "cpu", "triton")],
)
def test_resolve_decode_impl(impl, platform, want):
    assert resolve_decode_impl(impl, platform) == want


@pytest.mark.parametrize("impl,platform", [("pallas", "gpu"), ("auto", "rocm"), ("flash", "cpu")])
def test_resolve_decode_impl_rejects(impl, platform):
    with pytest.raises(ValueError):
        resolve_decode_impl(impl, platform)


def test_decode_attention_fn_names_what_runs():
    assert decode_attention_fn("gather") is paged_attention
    assert decode_attention_fn("triton") is paged_triton.paged_attention_triton
    with pytest.raises(ValueError):
        decode_attention_fn("pallas")


@pytest.mark.gpu
def test_kernel_on_card_matches_gather(gpu_device):
    """Compiled for the card at the 1B serving width: 96 slots, 128-token pages."""
    lens = np.random.default_rng(1).integers(1, 8 * 128 + 1, 96)
    lens[:3] = (1, 128, 8 * 128)
    q, kp, vp, table, lens = _case(4, 128, jnp.bfloat16, lens.tolist(), hkv=8, hd=64, max_pages=8)
    got = paged_attention_triton(q, kp, vp, table, lens)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        ref = paged_attention(f32(q), f32(kp), f32(vp), table, lens)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - ref)) / jnp.max(jnp.abs(ref)))
    assert err <= 1e-2, err


def test_tensor_parallel_engine_rejects_the_kernel():
    """The kernel is a per-device program: a tp mesh runs the gather path."""
    from ssi_jax.generate.paged_engine import PagedDecodeEngine
    from ssi_jax.models.llama3 import init_params
    from ssi_jax.parallel import make_mesh
    from tests import helpers

    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="gather"):
        PagedDecodeEngine(params, cfg, pad_id=0, n_slots=2, page_size=16, prompt_bucket=16, max_context=64,
                          attn_impl="triton", mesh=mesh)
    engine = PagedDecodeEngine(params, cfg, pad_id=0, n_slots=2, page_size=16, prompt_bucket=16, max_context=64,
                               mesh=mesh)
    assert (engine.attn_impl, engine.prefill_impl) == ("gather", "xla")
