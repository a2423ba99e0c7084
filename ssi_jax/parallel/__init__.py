"""Device mesh + sharding layout for SPMD training.

The reference scaffolds-but-never-initializes torch DDP (ref: SURVEY.md §2.4,
ssi/trainer.py:207,519). Here distribution is first-class: a 2-axis
``jax.sharding.Mesh`` ("dp", "tp"); gradients sync via the ``psum`` XLA inserts when
a jitted step consumes a dp-sharded batch with (possibly tp-sharded) params.

Layout rules (the "How to Scale Your Model" recipe — annotate, let XLA insert
the collectives, which run over NVLink/NCCL on GPUs):

- batch ``[accum, B, S]``: ``P(None, "dp", None)`` — micro-batch axis is scanned,
  the per-device batch axis is data-parallel.
- params: replicated over "dp"; over "tp" the stacked layer weights shard on the
  head/ffn output axis for up-projections (wq/wk/wv/w_gate/w_up) and on the input
  axis for down-projections (wo/w_down) — the Megatron pairing, so each block needs
  a single all-reduce per sub-layer, inserted by XLA. The tied embedding shards
  over the vocab axis, which also distributes the fused cross-entropy's
  ``[tokens, vocab]`` logits.
- optimizer state shards exactly like its parameter.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np

LOGGER = logging.getLogger(__name__)

__all__ = [
    "make_mesh",
    "param_specs",
    "param_shardings",
    "opt_state_shardings",
    "batch_sharding",
    "replicated",
    "shard_params",
    "initialize_distributed",
    "host_local_to_global",
    "full_host_copy",
]

_DIST_INITIALIZED = False

def _managed_multihost_env() -> bool:
    """True when a managed multi-node launcher (SLURM) is detected, where
    ``jax.distributed.initialize()`` can auto-detect coordinator + topology."""
    try:
        if int(os.getenv("SLURM_JOB_NUM_NODES", "1")) > 1:
            return True
    except ValueError:
        pass
    return False


def initialize_distributed(parallel_cfg: Any = None) -> bool:
    """Multi-process runtime init — the piece the reference scaffolds but never
    calls (ref: ssi/trainer.py:207 reads world_size from an uninitialized process
    group; SURVEY.md §2.4 "Comm backend: none initialized").

    Gating (``parallel.distributed`` config key, default "auto"):
    - ``false``: never initialize (single-process).
    - ``auto``: initialize iff explicit coordinator settings are present
      (``parallel.coordinator_address``/``num_processes``/``process_id`` or the
      ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` env
      vars) or a managed multi-node environment (SLURM) is detected.
    - ``true``: always call ``jax.distributed.initialize`` (JAX's own cluster
      auto-detection when no explicit settings are given; on a plain host
      without a cluster manager, pass the explicit settings).

    Returns True when running multi-process after the call. Idempotent.
    """
    global _DIST_INITIALIZED
    get = parallel_cfg.get if parallel_cfg is not None else (lambda *_: None)
    mode = get("distributed")
    mode = "auto" if mode is None else str(mode).lower()
    if mode in ("false", "off", "0", "no"):
        return False
    if _DIST_INITIALIZED:
        return jax.process_count() > 1

    coord = get("coordinator_address") or os.getenv("JAX_COORDINATOR_ADDRESS")
    nproc = get("num_processes") or os.getenv("JAX_NUM_PROCESSES")
    pid = get("process_id")
    if pid is None:
        pid = os.getenv("JAX_PROCESS_ID")
    explicit = coord is not None
    managed = _managed_multihost_env()
    if mode == "auto" and not (explicit or managed):
        return False
    if mode not in ("auto", "true", "on", "1", "yes"):
        raise ValueError(f"parallel.distributed must be bool or 'auto', got {mode!r}")

    kwargs = {}
    if explicit:
        if nproc is None or pid is None:
            raise ValueError(
                "parallel.coordinator_address is set but num_processes/process_id are not — "
                "set parallel.num_processes and parallel.process_id (or the "
                "JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars) alongside it."
            )
        kwargs = {
            "coordinator_address": str(coord),
            "num_processes": int(nproc),
            "process_id": int(pid),
        }
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if mode == "auto":
            # backend already up (e.g. single-process dev session that touched
            # devices before Trainer.setup): auto mode degrades gracefully
            LOGGER.warning(f"Skipping jax.distributed auto-init: {e}")
            return jax.process_count() > 1
        raise
    _DIST_INITIALIZED = True
    LOGGER.info(
        f"jax.distributed initialized: process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local of {jax.device_count()} global devices"
    )
    return jax.process_count() > 1


def host_local_to_global(arr: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Assemble a global array from this process's local shard.

    Single-process: plain ``device_put``. Multi-process: each process contributes
    its rows of the globally dp-sharded batch (the DistributedSampler-equivalent
    per-rank shard, ref: ssi/data/__init__.py:83,120) via
    ``jax.make_array_from_process_local_data``.
    """
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_process_local_data(sharding, np.asarray(arr))


def full_host_copy(tree: Any, mesh: Mesh) -> Any:
    """Fetch a complete host copy of a (possibly cross-host-sharded) pytree.

    Multi-process arrays are not fully addressable, so a jitted identity with
    replicated out-shardings all-gathers them across devices first; every host then
    holds the full value (used by checkpoint save, where process 0 writes)."""
    if jax.process_count() == 1:
        return jax.device_get(tree)
    rep = jax.jit(
        lambda t: t,
        out_shardings=jax.tree.map(lambda _: replicated(mesh), tree),
    )(tree)
    return jax.device_get(rep)


def make_mesh(
    dp: int | None = None,
    tp: int = 1,
    devices: list | None = None,
    dcn_slices: int | None = None,
) -> Mesh:
    """Create a ("dp", "tp") mesh over the available devices.

    Within one host every GPU reaches every other over NVLink at the same rate,
    so a single-host mesh is a plain reshape of the device list. For multi-node
    runs, ``dcn_slices`` groups the devices host-major: tensor parallelism
    stays inside a group (per-sub-layer all-reduces want the fast intra-host
    links), and contiguous dp index ranges live in one group, so the gradient
    all-reduce — one collective per optimizer step — is the only traffic that
    crosses between nodes. Step semantics are identical to a flat mesh; the
    layout only changes which links the collectives use.

    Args:
        dp: data-parallel size; ``None`` = all devices / tp.
        tp: tensor-parallel size; must divide the per-group device count.
        devices: explicit device list (tests); default ``jax.devices()``.
        dcn_slices: number of host groups (``None`` = one); devices are split
            into ``dcn_slices`` equal contiguous groups.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)

    if dcn_slices is None:
        groups = [devices]
    else:
        if n % dcn_slices != 0:
            raise ValueError(f"Device count {n} not divisible by dcn_slices={dcn_slices}")
        per = n // dcn_slices
        groups = [devices[i * per : (i + 1) * per] for i in range(dcn_slices)]

    if len(groups) > 1:
        sizes = {len(g) for g in groups}
        if len(sizes) != 1:
            raise ValueError(f"Unequal slice sizes {sorted(len(g) for g in groups)}; cannot build a regular mesh")
        per = len(groups[0])
        if per % tp != 0:
            raise ValueError(
                f"tp={tp} does not divide the per-group device count {per} — "
                f"tensor parallelism must not cross a host-group boundary"
            )
        dp_inner = per // tp
        dp_total = dp_inner * len(groups)
        if dp is not None and dp != dp_total:
            raise ValueError(f"dp={dp} inconsistent with {len(groups)} slices x {dp_inner} per-slice dp")
        grid = np.stack([np.asarray(g).reshape(dp_inner, tp) for g in groups])  # [S, dp_inner, tp]
        device_grid = grid.reshape(dp_total, tp)  # group-major dp ordering
        LOGGER.info(
            f"Hybrid mesh over {len(groups)} host groups: dp={dp_total} (group-major) x tp={tp} (intra-group)"
        )
        return Mesh(device_grid, axis_names=("dp", "tp"))

    if dp is None:
        if n % tp != 0:
            raise ValueError(f"Device count {n} not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"Requested dp*tp = {dp * tp} exceeds available devices ({n})")
    if dp * tp < n:
        LOGGER.warning(f"Mesh dp={dp} x tp={tp} uses {dp * tp} of {n} available devices; the rest stay idle.")
    device_grid = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(device_grid, axis_names=("dp", "tp"))


def param_specs(params: Any) -> Any:
    """PartitionSpec pytree for the stacked Llama params (tp sharding rules)."""
    specs = {
        "embed": P("tp", None),  # vocab-sharded: distributes fused-CE logits too
        "lm_head": P("tp", None),  # untied output head (8B): same vocab sharding
        "final_norm": P(),
        "layers": {
            "attn_norm": P(),
            "mlp_norm": P(),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        },
    }

    def pick(path, _leaf):
        node: Any = specs
        for p in path:
            node = node[p.key]
        return node

    return jax.tree_util.tree_map_with_path(pick, params)


def _divisible_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Drop mesh axes that do not divide the corresponding array dimension.

    device_put of concrete arrays requires exact divisibility (unlike GSPMD inside
    jit, which pads). E.g. the extended vocab 133258 shards over tp=2 but not tp=4
    — fall back to replication for that dimension rather than fail.
    """
    out = []
    changed = False
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is not None and dim % mesh.shape[axis] != 0:
            LOGGER.warning(
                f"Array dim {dim} not divisible by mesh axis {axis!r}={mesh.shape[axis]}; replicating that dim."
            )
            out.append(None)
            changed = True
        else:
            out.append(axis)
    return P(*out) if changed else spec


def param_shardings(mesh: Mesh, params: Any, *, fsdp: bool = False) -> Any:
    """NamedSharding tree for params: tp layout; ``fsdp`` adds dp (ZeRO-3).

    With ``fsdp`` the *resident* parameter buffers additionally shard over the
    dp axis (same augmentation rule as the ZeRO-1 moments); the forward's
    per-layer weight slices are all-gathered by XLA where consumed, so
    persistent params + grads + moments all divide by dp.
    """
    base = jax.tree.map(
        lambda spec, leaf: NamedSharding(mesh, _divisible_spec(spec, leaf.shape, mesh)),
        param_specs(params),
        params,
        is_leaf=lambda x: isinstance(x, P),
    )
    if not fsdp:
        return base
    return jax.tree.map(
        lambda s, leaf: NamedSharding(mesh, _zero1_spec(s.spec, leaf.shape, mesh)),
        base,
        params,
    )


def shard_params(mesh: Mesh, params: Any, *, fsdp: bool = False) -> Any:
    """Place a (host) param pytree onto the mesh with the tp (+ optional fsdp) layout."""
    return jax.device_put(params, param_shardings(mesh, params, fsdp=fsdp))


def _zero1_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Augment a (tp-resolved) spec with "dp" on the first shardable dimension.

    ZeRO-1 layout rule: optimizer moments additionally shard over the data-parallel
    axis so their persistent HBM footprint divides by dp. Preference order per leaf:
    the first dimension that is unsharded and divisible by dp; else co-shard a
    tp-sharded dimension as ("tp", "dp") when divisible by tp*dp; else leave the
    leaf as-is (tiny scalars/norm vectors dominate nothing).
    """
    dp = mesh.shape["dp"]
    if dp == 1:
        return spec
    axes = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if ax is None and dim % dp == 0:
            axes[i] = "dp"
            return P(*axes)
    for i, (dim, ax) in enumerate(zip(shape, axes)):
        if ax == "tp" and dim % (dp * mesh.shape["tp"]) == 0:
            axes[i] = ("tp", "dp")
            return P(*axes)
    return spec


def opt_state_shardings(mesh: Mesh, params: Any, *, zero1: bool = False) -> dict[str, Any]:
    """NamedSharding tree for AdamW state ({mu, nu, count}).

    Default: moments shard exactly like their parameter (replicated over dp).
    ``zero1``: moments additionally shard over dp (ZeRO-1) — XLA then reduce-
    scatters gradients into the moment update and all-gathers the fresh params,
    the same bytes as the plain all-reduce but with the optimizer state and
    update compute partitioned across the dp group. (Under fsdp the moments get
    the identical augmentation, so zero1=True covers both.)
    """
    p_shardings = param_shardings(mesh, params)
    if zero1:
        moment = jax.tree.map(
            lambda s, leaf: NamedSharding(mesh, _zero1_spec(s.spec, leaf.shape, mesh)),
            p_shardings,
            params,
        )
    else:
        moment = p_shardings
    return {"mu": moment, "nu": moment, "count": NamedSharding(mesh, P())}


def batch_sharding(mesh: Mesh, accum_axis: bool = True) -> NamedSharding:
    """Sharding for a collated batch: dp on the per-device batch axis."""
    spec = P(None, "dp", None) if accum_axis else P("dp", None)
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
