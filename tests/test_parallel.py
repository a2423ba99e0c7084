"""Mesh/sharding semantics: the same training step must compute the same numbers
on every mesh layout (dp/tp partitioning is an implementation detail, not math)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ssi_jax.models.llama3 import init_params
from ssi_jax.parallel import batch_sharding, make_mesh, param_specs, shard_params
from ssi_jax.train.lr_schedule import constant_schedule
from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
from ssi_jax.train.step import make_train_step
from tests import helpers


def test_param_specs_layout():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    specs = param_specs(params)
    assert specs["embed"] == P("tp", None)  # vocab-sharded tied embedding
    assert specs["layers"]["wq"] == P(None, None, "tp")
    assert specs["layers"]["wo"] == P(None, "tp", None)
    assert specs["layers"]["w_down"] == P(None, "tp", None)
    assert specs["final_norm"] == P()


def _loss_and_grads(mesh_shape, tokens, labels):
    from ssi_jax.train.step import make_loss_fn

    cfg = helpers.tiny_config()
    dp, tp = mesh_shape
    mesh = make_mesh(dp=dp, tp=tp)
    params = shard_params(mesh, init_params(cfg, jax.random.key(0), dtype=jnp.float32))
    loss_fn = make_loss_fn(cfg, attn_impl="xla", remat=False, chunk_size=64)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, t, y: loss_fn(p, t, y)[0]))
    bsh = batch_sharding(mesh, accum_axis=False)
    loss, grads = grad_fn(params, jax.device_put(tokens, bsh), jax.device_put(labels, bsh))
    return float(loss), jax.device_get(grads)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (1, 4), (4, 2)])
def test_loss_and_grads_invariant_to_mesh_layout(mesh_shape):
    cfg = helpers.tiny_config()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = -100

    ref_loss, ref_grads = _loss_and_grads((1, 1), tokens, labels)
    loss, grads = _loss_and_grads(mesh_shape, tokens, labels)
    # SPMD partitioning changes reduction order -> tolerance, not bitwise
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=2e-5)


def test_optimizer_step_runs_on_every_mesh():
    """Full train step (grad accum + AdamW) executes on each layout with equal token counts."""
    cfg = helpers.tiny_config()
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8, 64)).astype(np.int32)
    losses = {}
    for mesh_shape in [(1, 1), (2, 2), (8, 1)]:
        mesh = make_mesh(dp=mesh_shape[0], tp=mesh_shape[1])
        params = shard_params(mesh, init_params(cfg, jax.random.key(0), dtype=jnp.float32))
        opt_cfg = AdamWConfig(lr=1e-3, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
        state = {"params": params, "opt_state": init_opt_state(params, opt_cfg), "step": jnp.zeros((), jnp.int32)}
        step = make_train_step(cfg, opt_cfg, constant_schedule(1e-3), clip_grad_norm=1.0, chunk_size=64, donate=False)
        bsh = batch_sharding(mesh)
        _, m = step(state, jax.device_put(tokens, bsh), jax.device_put(tokens.copy(), bsh))
        losses[mesh_shape] = (float(m["loss_sum"]), int(m["num_tokens"]))
    counts = {v[1] for v in losses.values()}
    assert len(counts) == 1  # token accounting identical across layouts
    ref = losses[(1, 1)][0]
    for v in losses.values():
        assert v[0] == pytest.approx(ref, rel=1e-5)


def test_uneven_vocab_tp_sharding_falls_back():
    """Vocab 530 doesn't divide tp=4: the embed dim must replicate, not fail."""
    cfg = helpers.tiny_config()
    assert cfg.vocab_size % 4 != 0
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    loss, _ = _loss_and_grads((2, 4), tokens, tokens.copy())
    assert np.isfinite(loss)


class TestHybridDcnMesh:
    """Multi-node (host-grouped) mesh: group-major dp ordering, tp confined to a group."""

    def test_layout_is_slice_major(self):
        devices = jax.devices()
        mesh = make_mesh(tp=2, dcn_slices=2)
        assert mesh.shape == {"dp": 4, "tp": 2}
        grid = mesh.devices
        # dp rows 0..1 must come from the first "slice" (contiguous device group)
        first_slice = set(devices[:4])
        assert set(grid[:2].ravel().tolist()) == first_slice
        assert set(grid[2:].ravel().tolist()) == set(devices[4:])
        # every tp pair lives inside one slice
        for row in grid:
            assert {d in first_slice for d in row} in ({True}, {False})

    def test_tp_crossing_dcn_rejected(self):
        with pytest.raises(ValueError, match="host-group boundary"):
            make_mesh(tp=8, dcn_slices=2)  # per-slice count 4 < tp

    def test_unequal_and_indivisible_slices_rejected(self):
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(tp=1, dcn_slices=3)

    def test_training_step_matches_single_slice(self):
        """A 2-slice hybrid mesh computes the same loss/grads as dp=8 flat."""
        cfg = helpers.tiny_config()
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
        labels = tokens.copy()

        ref_loss, ref_grads = _loss_and_grads((8, 1), tokens, labels)

        from ssi_jax.train.step import make_loss_fn

        mesh = make_mesh(dcn_slices=2, tp=2)
        params = shard_params(mesh, init_params(cfg, jax.random.key(0), dtype=jnp.float32))
        loss_fn = make_loss_fn(cfg, attn_impl="xla", remat=False, chunk_size=64)
        grad_fn = jax.jit(jax.value_and_grad(lambda p, t, y: loss_fn(p, t, y)[0]))
        bsh = batch_sharding(mesh, accum_axis=False)
        loss, grads = grad_fn(params, jax.device_put(tokens, bsh), jax.device_put(labels, bsh))
        assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
        for a, b in zip(jax.tree.leaves(jax.device_get(grads)), jax.tree.leaves(ref_grads)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=2e-5)


class TestZero1:
    """ZeRO-1: AdamW moments shard over dp; math must equal replicated state."""

    def test_spec_augmentation(self):
        from ssi_jax.parallel import _zero1_spec

        mesh = make_mesh(dp=4, tp=2)
        # first unsharded divisible dim takes "dp"
        assert _zero1_spec(P("tp", None), (530, 64), mesh) == P("tp", "dp")
        assert _zero1_spec(P(None, None, "tp"), (2, 64, 32), mesh) == P(None, "dp", "tp")
        assert _zero1_spec(P(), (64,), mesh) == P("dp")
        # nothing divisible: unchanged (no crash)
        assert _zero1_spec(P(), (3, 5), mesh) == P()
        # co-shard a tp dim when it's the only divisible one
        assert _zero1_spec(P(None, "tp"), (3, 16), mesh) == P(None, ("tp", "dp"))

    @pytest.mark.parametrize("mode", ["zero1", "fsdp"])
    def test_step_matches_replicated_and_shrinks_moments(self, mode):
        from ssi_jax.parallel import opt_state_shardings, param_shardings

        cfg = helpers.tiny_config()
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab_size, (2, 8, 64)).astype(np.int32)
        out = {}
        for sharded in (False, True):
            fsdp = sharded and mode == "fsdp"
            mesh = make_mesh(dp=4, tp=2)
            params = shard_params(mesh, init_params(cfg, jax.random.key(0), dtype=jnp.float32), fsdp=fsdp)
            opt_cfg = AdamWConfig(lr=1e-3, mu_dtype=jnp.float32, nu_dtype=jnp.float32)
            osh = opt_state_shardings(mesh, params, zero1=sharded)
            opt_state = jax.jit(lambda p: init_opt_state(p, opt_cfg), out_shardings=osh)(params)
            state = {"params": params, "opt_state": opt_state, "step": jnp.zeros((), jnp.int32)}
            step = make_train_step(
                cfg,
                opt_cfg,
                constant_schedule(1e-3),
                clip_grad_norm=1.0,
                chunk_size=64,
                donate=False,
                state_shardings=(
                    {"params": param_shardings(mesh, params, fsdp=fsdp), "opt_state": osh}
                    if sharded
                    else None
                ),
            )
            bsh = batch_sharding(mesh)
            new_state, m = step(state, jax.device_put(tokens, bsh), jax.device_put(tokens.copy(), bsh))
            out[sharded] = (jax.device_get(new_state), float(m["loss_sum"]), int(m["num_tokens"]))
            if sharded:
                mu_embed = new_state["opt_state"]["mu"]["embed"]
                # persistent moment buffer is 1/(dp*tp) per device, dp in the layout
                assert "dp" in jax.tree.leaves(tuple(mu_embed.sharding.spec))
                assert mu_embed.addressable_shards[0].data.size * 8 == mu_embed.size
                if fsdp:
                    p_embed = new_state["params"]["embed"]
                    assert "dp" in jax.tree.leaves(tuple(p_embed.sharding.spec))
                    assert p_embed.addressable_shards[0].data.size * 8 == p_embed.size

        assert out[True][2] == out[False][2]  # token accounting identical
        assert out[True][1] == pytest.approx(out[False][1], rel=1e-6)
        # Grad reduce-scatter changes fp32 summation order; near-zero grads at step 1
        # (denom ~ eps) amplify that into ~3e-5 on isolated params. Bound abs error
        # well under the 1e-3 update scale.
        for a, b in zip(jax.tree.leaves(out[True][0]["params"]), jax.tree.leaves(out[False][0]["params"])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)
        for a, b in zip(jax.tree.leaves(out[True][0]["opt_state"]["mu"]), jax.tree.leaves(out[False][0]["opt_state"]["mu"])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)  # reduce-scatter reduction order


def test_8b_fsdp_aot_compile():
    """AOT lower+compile of the FSDP-sharded REAL Llama 3.1 8B train step on the
    8-device virtual mesh — the multi-chip scale target (bf16 params+moments
    ~48 GB never fit one chip, so FSDP *is* the 8B train path). Certifies the
    untied-lm_head registry entry through the full parallel pipeline:
    param/moment dp-sharding specs, reduce-scatter/all-gather insertion,
    vocab-sharded CE against the separate (untied) lm_head. ShapeDtypeStructs
    only — nothing is materialized.

    Ref: /root/reference/ssi/llama_configs.py:142-155 (the reference's scale
    ladder); BASELINE configs[4] ("stretch to Llama-3-8B").
    """
    from ssi_jax.models.configs import MODEL_CONFIGS
    from ssi_jax.parallel import opt_state_shardings, param_shardings

    cfg = MODEL_CONFIGS["llama3_1_8b"].copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True
    assert not cfg.tied_embeddings

    mesh = make_mesh(dp=4, tp=2)
    p_shapes = jax.eval_shape(lambda k: init_params(cfg, k, dtype=jnp.bfloat16), jax.random.key(0))
    assert p_shapes["layers"]["wq"].shape == (32, 4096, 4096)
    assert p_shapes["lm_head"].shape == (cfg.vocab_size, 4096)  # untied output head
    psh = param_shardings(mesh, p_shapes, fsdp=True)
    opt_cfg = AdamWConfig(lr=1e-4)
    o_shapes = jax.eval_shape(lambda p: init_opt_state(p, opt_cfg), p_shapes)
    osh = opt_state_shardings(mesh, p_shapes, zero1=True)

    def attach(shapes, shardings):
        return jax.tree.map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            shapes,
            shardings,
        )

    state_shapes = {
        "params": attach(p_shapes, psh),
        "opt_state": attach(o_shapes, osh),
        "step": jax.ShapeDtypeStruct((), jnp.int32),
    }
    step = make_train_step(
        cfg,
        opt_cfg,
        constant_schedule(1e-4),
        attn_impl="xla",
        chunk_size=2048,
        donate=False,
        state_shardings={"params": psh, "opt_state": osh},
    )
    tok = jax.ShapeDtypeStruct((1, 8, 256), jnp.int32, sharding=batch_sharding(mesh))
    compiled = step.lower(state_shapes, tok, tok).compile()

    out_psh = compiled.output_shardings[0]["params"]
    assert "dp" in jax.tree.leaves(tuple(out_psh["embed"].spec))
    assert "dp" in jax.tree.leaves(tuple(out_psh["lm_head"].spec))
    out_mush = compiled.output_shardings[0]["opt_state"]["mu"]
    assert "dp" in jax.tree.leaves(tuple(out_mush["lm_head"].spec))


def test_3b_fsdp_aot_compile():
    """AOT lower+compile (not just an abstract trace) of the FSDP-sharded REAL
    3B train step on the 8-device virtual mesh: certifies the 3B registry entry
    through the full parallel path — param/moment dp-sharding specs, XLA
    reduce-scatter/all-gather insertion, vocab-sharded CE — without ever
    materializing the ~6.4 GB of parameters (inputs stay ShapeDtypeStructs).

    Ref: /root/reference/ssi/llama_configs.py:142-155 (3B singleton the
    reference declares but never trains).
    """
    from ssi_jax.models.configs import MODEL_CONFIGS
    from ssi_jax.parallel import opt_state_shardings, param_shardings

    cfg = MODEL_CONFIGS["llama3_2_3b"].copy()
    cfg.n_dsus = 5000
    cfg.modality_tokens = True

    mesh = make_mesh(dp=4, tp=2)
    p_shapes = jax.eval_shape(
        lambda k: init_params(cfg, k, dtype=jnp.bfloat16), jax.random.key(0)
    )
    assert p_shapes["layers"]["wq"].shape == (28, 3072, 3072)
    psh = param_shardings(mesh, p_shapes, fsdp=True)
    opt_cfg = AdamWConfig(lr=1e-4)
    o_shapes = jax.eval_shape(lambda p: init_opt_state(p, opt_cfg), p_shapes)
    osh = opt_state_shardings(mesh, p_shapes, zero1=True)

    def attach(shapes, shardings):
        return jax.tree.map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            shapes,
            shardings,
        )

    state_shapes = {
        "params": attach(p_shapes, psh),
        "opt_state": attach(o_shapes, osh),
        "step": jax.ShapeDtypeStruct((), jnp.int32),
    }
    step = make_train_step(
        cfg,
        opt_cfg,
        constant_schedule(1e-4),
        attn_impl="xla",
        chunk_size=2048,
        donate=False,
        state_shardings={"params": psh, "opt_state": osh},
    )
    tok = jax.ShapeDtypeStruct((1, 8, 256), jnp.int32, sharding=batch_sharding(mesh))
    compiled = step.lower(state_shapes, tok, tok).compile()

    # Resident params and moments really are dp-sharded in the compiled layout.
    out_psh = compiled.output_shardings[0]["params"]
    assert "dp" in jax.tree.leaves(tuple(out_psh["embed"].spec))
    out_mush = compiled.output_shardings[0]["opt_state"]["mu"]
    assert "dp" in jax.tree.leaves(tuple(out_mush["embed"].spec))
