"""Tensor-parallel serving on a virtual mesh: the paged engine with a tp=2
mesh must emit the same greedy outputs as the single-device engine (the vLLM
``tensor_parallel_size`` role; ref reaches it through vLLM at
scripts/generate.py:112-118).

Sharding is the training TP rule set (parallel.param_specs) applied to the
decode weights plus kv-head-axis pools; GSPMD inserts the per-layer psums.
Outputs are compared as token streams (f32 CPU: reduction-order noise is far
below tiny-model greedy margins at these seeds).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_jax.generate.engine import SamplingParams
from ssi_jax.generate.paged_engine import PagedDecodeEngine
from ssi_jax.models.llama3 import init_params
from ssi_jax.parallel import make_mesh
from tests import helpers
from tests.test_paged_decode import make_engine, naive_greedy

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >= 2 devices (virtual CPU mesh)"
)


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, params


def test_tp2_matches_single_device(setup):
    cfg, params = setup
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3]]
    sp = SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=())

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    engine = make_engine(params, cfg, mesh=mesh)
    assert engine.attn_impl == "gather"
    outs = engine.generate_batch(prompts, sp)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 6)


def test_tp2_weights_and_pools_are_sharded(setup):
    cfg, params = setup
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    engine = make_engine(params, cfg, mesh=mesh)
    wq_spec = engine.params["layers"]["wq"].sharding.spec
    assert tuple(wq_spec) == (None, None, "tp")
    pool_spec = engine.pools["k"].sharding.spec
    assert tuple(pool_spec) == (None, None, "tp")
    # each device holds half the head features
    shard = next(iter(engine.params["layers"]["wq"].addressable_shards))
    assert shard.data.shape[-1] == engine.params["layers"]["wq"].shape[-1] // 2


def test_tp2_composes_with_prefix_cache_and_refill(setup):
    """Continuous batching + cross-request prefix caching under TP: more
    prompts than slots, second stream hits the cache, outputs lossless."""
    cfg, params = setup
    rng = np.random.default_rng(67)
    shared = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [4, 6, 9, 2, 7]]
    sp = SamplingParams(temperature=0.0, max_tokens=5, stop_token_ids=())

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    engine = make_engine(params, cfg, n_slots=3, mesh=mesh)
    outs = engine.generate_batch(prompts, sp)
    assert engine.last_stats["cached_prompt_tokens"] > 0
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 5)
    outs2 = engine.generate_batch(prompts[:2], sp)  # cache spans streams
    assert engine.last_stats["cached_prompt_tokens"] >= 16
    for prompt, out in zip(prompts[:2], outs2):
        assert out["token_ids"] == naive_greedy(params, cfg, prompt, 5)


def test_tp_rejects_int8(setup):
    cfg, params = setup
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="quantize"):
        make_engine(params, cfg, mesh=mesh, quantize="int8")
