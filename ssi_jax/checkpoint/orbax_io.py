"""Orbax-backed sharded optimizer-state checkpointing (multi-host scale path).

The default resume state gathers the full optimizer pytree to host rank 0 and
writes one msgpack blob — the reference contract (ref: ssi/checkpoint.py:435-468
via torch.save), fine at 1B single-host scale. On multi-host meshes that full
gather is the save bottleneck (every device's shards cross the network to rank 0, and
rank 0 needs RAM for the whole state). With
``sharded_optimizer_state: true`` the Trainer instead writes the optimizer
pytree through Orbax: every process persists exactly its own shards in
parallel, and restore re-shards to whatever mesh the resumed run uses (the
relayout path the msgpack route handles by replicate-then-reshard).

The training_state.msgpack schema is unchanged except that ``optimizer``
becomes a ``{"__orbax_dir__": <relative dir>}`` marker; everything else (RNG,
counters, hparams) stays in msgpack — those are tiny host-side values.

Round-trip is bitwise: Orbax stores raw array bytes (bf16 moments included),
asserted by tests/test_checkpoint.py sharded-resume tests.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp

LOGGER = logging.getLogger(__name__)

ORBAX_DIR_KEY = "__orbax_dir__"
_DIR_PREFIX = "optimizer_state_orbax_step"


def is_orbax_marker(optimizer_state: Any) -> bool:
    return isinstance(optimizer_state, dict) and ORBAX_DIR_KEY in optimizer_state


def save_opt_state(opt_state: Any, output_dir: Path, step: int) -> dict[str, str]:
    """Collective sharded save; every process writes its own shards.

    Returns the msgpack marker. Caller must invoke on ALL processes.
    """
    import orbax.checkpoint as ocp

    rel = f"{_DIR_PREFIX}{step}"
    path = (Path(output_dir) / rel).resolve()
    # A crash between this save and the msgpack commit leaves a stale dir for
    # the same step; the msgpack referencing it was never written, so the dir
    # is dead weight — remove it rather than letting Orbax's exists-check kill
    # every re-save at this step after resume. StandardCheckpointer.save is
    # collective but the filesystem write of a given shard happens on exactly
    # one process, so the rank-0-coordinated overwrite below is safe: Orbax's
    # save barrier means no process can be mid-read of the old dir.
    if jax.process_index() == 0 and path.exists():
        import shutil

        LOGGER.warning("Removing stale uncommitted optimizer dir %s", path)
        shutil.rmtree(path, ignore_errors=True)
    if jax.process_count() > 1:
        # Orbax's own exists-check runs on every process: barrier so none of
        # them race ahead of rank 0's removal.
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"orbax_stale_rm_{step}")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, opt_state)  # waits on exit of the context
    return {ORBAX_DIR_KEY: rel}


def prune_old_opt_states(output_dir: Path, keep_step: int) -> None:
    """Delete superseded orbax optimizer dirs (call after the state msgpack
    referencing ``keep_step`` has been atomically written; rank 0 only)."""
    import shutil

    keep = f"{_DIR_PREFIX}{keep_step}"
    for d in Path(output_dir).glob(f"{_DIR_PREFIX}*"):
        if d.is_dir() and d.name != keep:
            shutil.rmtree(d, ignore_errors=True)


def restore_opt_state(
    marker: dict[str, str],
    state_dir: Path,
    params: Any,
    opt_cfg: Any,
    shardings: dict[str, Any],
) -> dict[str, Any]:
    """Restore the optimizer pytree directly into the current mesh shardings.

    ``state_dir``: directory containing training_state.msgpack (markers hold
    paths relative to it). ``shardings``: {"mu": tree, "nu": tree, "count": s}
    matching param_shardings of the resuming mesh — Orbax re-shards on read,
    so each process fetches only the bytes it needs.
    """
    import orbax.checkpoint as ocp

    path = (Path(state_dir) / marker[ORBAX_DIR_KEY]).resolve()
    if not path.exists():
        raise FileNotFoundError(
            f"Sharded optimizer state {path} not found (marker {marker!r} in {state_dir})"
        )

    def sds(leaf, sharding, dtype):
        return jax.ShapeDtypeStruct(leaf.shape, dtype, sharding=sharding)

    abstract = {
        "mu": jax.tree.map(lambda p, s: sds(p, s, opt_cfg.mu_dtype), params, shardings["mu"]),
        "nu": jax.tree.map(lambda p, s: sds(p, s, opt_cfg.nu_dtype), params, shardings["nu"]),
        "count": jax.ShapeDtypeStruct((), jnp.int32, sharding=shardings["count"]),
    }
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(path, abstract)
    return restored
