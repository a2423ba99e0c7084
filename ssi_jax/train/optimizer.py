"""First-party AdamW with explicit per-buffer dtypes.

Replaces torch's fused AdamW (ref: ssi/optimizer.py:8-17, conf/training.yaml:2-10).
Written as a pure pytree update so that

- XLA fuses the whole update into the train step (the analog of ``fused: true``);
- the optimizer state is a plain pytree -> msgpack-serializable for the schema-v1
  training state, and shards exactly like its parameter under the mesh;
- moment dtypes are explicit: first moment defaults to bf16 (HBM economy), second
  moment to fp32 (dynamic range), update math always in fp32.

Semantics match torch.optim.AdamW (decoupled weight decay, bias correction,
eps added after the bias-corrected sqrt).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-4  # base lr; the schedule overrides per step
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    mu_dtype: Any = jnp.bfloat16
    nu_dtype: Any = jnp.float32
    # Stochastic rounding when storing moments in bf16: round-to-nearest silently
    # drops moment updates smaller than ~0.4% of the stored value (bf16 has 8
    # mantissa bits), which freezes slow-moving second moments; rounding up/down
    # with probability proportional to the remainder keeps the expected value
    # exact. Deterministic given the step counter (resume-safe).
    stochastic_rounding: bool = False

    @classmethod
    def from_cfg(cls, cfg_optimizer: Any) -> "AdamWConfig":
        betas = cfg_optimizer.get("betas", [0.9, 0.999])
        dtype_map = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
        return cls(
            lr=float(cfg_optimizer.lr),
            b1=float(betas[0]),
            b2=float(betas[1]),
            eps=float(cfg_optimizer.get("eps", 1e-8)),
            weight_decay=float(cfg_optimizer.get("weight_decay", 0.01)),
            mu_dtype=dtype_map[cfg_optimizer.get("mu_dtype", "bf16")],
            nu_dtype=dtype_map[cfg_optimizer.get("nu_dtype", "fp32")],
            stochastic_rounding=bool(cfg_optimizer.get("stochastic_rounding", False)),
        )


def _stochastic_round_bf16(x32: jnp.ndarray, key: jax.Array) -> jnp.ndarray:
    """fp32 -> bf16 with stochastic rounding (add uniform low bits, truncate)."""
    bits = jax.lax.bitcast_convert_type(x32, jnp.uint32)
    noise = jax.random.bits(key, x32.shape, jnp.uint32) & jnp.uint32(0xFFFF)
    rounded = (bits + noise) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(rounded, jnp.float32).astype(jnp.bfloat16)


def _store(x32: jnp.ndarray, dtype: Any, key: jax.Array | None) -> jnp.ndarray:
    if key is not None and dtype == jnp.bfloat16:
        return _stochastic_round_bf16(x32, key)
    return x32.astype(dtype)


def init_opt_state(params: Params, cfg: AdamWConfig) -> dict[str, Any]:
    return {
        "mu": jax.tree.map(lambda p: jnp.zeros(p.shape, cfg.mu_dtype), params),
        "nu": jax.tree.map(lambda p: jnp.zeros(p.shape, cfg.nu_dtype), params),
        "count": jnp.zeros((), jnp.int32),
    }


def adamw_update(
    grads: Params,
    opt_state: dict[str, Any],
    params: Params,
    lr: jnp.ndarray,
    cfg: AdamWConfig,
) -> tuple[Params, dict[str, Any]]:
    """One AdamW step. ``grads`` must already be scaled/clipped by the caller.

    Returns (new_params, new_opt_state). All math in fp32, storage in the
    configured dtypes; params are updated in their own dtype.
    """
    count = opt_state["count"] + 1
    c = count.astype(jnp.float32)
    bias_c1 = 1.0 - cfg.b1**c
    bias_c2 = 1.0 - cfg.b2**c
    base_key = jax.random.fold_in(jax.random.key(0x5AD), count) if cfg.stochastic_rounding else None

    def leaf_update(i, p, g, mu, nu):
        g32 = g.astype(jnp.float32)
        mu32 = cfg.b1 * mu.astype(jnp.float32) + (1.0 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.astype(jnp.float32) + (1.0 - cfg.b2) * (g32 * g32)
        mhat = mu32 / bias_c1
        denom = jnp.sqrt(nu32 / bias_c2) + cfg.eps
        p32 = p.astype(jnp.float32)
        p32 = p32 - lr * (mhat / denom + cfg.weight_decay * p32)
        if base_key is not None:
            k_mu, k_nu = jax.random.split(jax.random.fold_in(base_key, i))
        else:
            k_mu = k_nu = None
        return p32.astype(p.dtype), _store(mu32, cfg.mu_dtype, k_mu), _store(nu32, cfg.nu_dtype, k_nu)

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_mu = treedef.flatten_up_to(opt_state["mu"])
    flat_nu = treedef.flatten_up_to(opt_state["nu"])
    new = [leaf_update(i, p, g, mu, nu) for i, (p, g, mu, nu) in enumerate(zip(flat_p, flat_g, flat_mu, flat_nu))]
    new_params = jax.tree.unflatten(treedef, [x[0] for x in new])
    new_mu = jax.tree.unflatten(treedef, [x[1] for x in new])
    new_nu = jax.tree.unflatten(treedef, [x[2] for x in new])
    return new_params, {"mu": new_mu, "nu": new_nu, "count": count}


def global_norm(tree: Params) -> jnp.ndarray:
    leaves = jax.tree.leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32))) for x in leaves))


def clip_by_global_norm(tree: Params, max_norm: float) -> tuple[Params, jnp.ndarray]:
    """torch.nn.utils.clip_grad_norm_ semantics: scale = max_norm / (norm + 1e-6)."""
    norm = global_norm(tree)
    scale = jnp.minimum(1.0, max_norm / (norm + 1e-6))
    return jax.tree.map(lambda x: (x.astype(jnp.float32) * scale).astype(x.dtype), tree), norm
