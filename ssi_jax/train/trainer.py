"""Host-side Trainer: thin stateful loop around the jitted functional core.

Rebuild of the reference Trainer (ref: ssi/trainer.py:128-521) with the
Accelerator-first inversions from SURVEY.md §7:

- All device state lives in one pytree ``{params, opt_state, step}`` threaded
  through a single jitted ``train_step`` that consumes a whole gradient-
  accumulation window ``[accum, batch, seq]`` per call (ref runs accum separate
  fwd/bwd host iterations: ssi/trainer.py:377-394).
- Distribution is a ("dp","tp") ``jax.sharding.Mesh``; the batch is dp-sharded,
  params are tp-sharded/replicated, and XLA inserts the gradient all-reduce the
  reference never built (SURVEY.md §2.4).
- Checkpoint/resume keeps the reference's schema-v1 contract: ``step_N/`` HF dirs
  + a versioned training state; resume = epoch derivation + micro-batch skip +
  host RNG restore (ref: ssi/trainer.py:334-352, §3.5).

Setup/teardown protocol is identical: ``Trainer(cfg).setup(); .train(); .cleanup()``.
"""

from __future__ import annotations

from collections import defaultdict
import copy
import itertools
import logging
import os
from pathlib import Path
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ssi_jax import __version__
from ssi_jax.checkpoint import Checkpointer, resolve_checkpointer_output_dir, restore_rng_states
from ssi_jax.constants import DEBUGGING_TAG, SEED
from ssi_jax.data import Loader, Sampler, setup_sft_data, setup_text_completion_data
from ssi_jax.models.configs import get_model_config
from ssi_jax.parallel import (
    batch_sharding,
    full_host_copy,
    host_local_to_global,
    initialize_distributed,
    make_mesh,
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from ssi_jax.tokenizer import setup_llama3_tokenizer
from ssi_jax.train.geometry import TrainingGeometry
from ssi_jax.train.lr_schedule import setup_lr_schedule
from ssi_jax.train.metric_logging import setup_metric_logger
from ssi_jax.train.optimizer import AdamWConfig, init_opt_state
from ssi_jax.train.step import compute_dataset_loss, make_eval_step, make_train_step
from ssi_jax.train.train_utils import (
    get_token_type_ranges,
    resume_training_state,
    validate_resume_hparams,
    validate_train_cfg,
)

__all__ = ["Trainer"]

LOGGER = logging.getLogger(__name__)

_DTYPES = {"bf16": jnp.bfloat16, "fp32": jnp.float32}


class Trainer:
    """Stateful trainer for speech-integration experiments.

    Args:
        cfg: composed config (ssi_jax.config.Config or any duck-typed mapping).
    """

    def __init__(self, cfg: Any) -> None:
        self.cfg = cfg

        # Components — populated by setup()
        self.state: dict[str, Any] | None = None  # {params, opt_state, step} on device
        self.tokenizer = None
        self.checkpointer: Checkpointer | None = None
        self.metric_logger = None
        self.mesh = None
        self.train_step = None
        self.eval_step = None
        self.lr_schedule = None

        # Data
        self.data_train: Loader | None = None
        self.sampler_train: Sampler | None = None
        self.data_dev: Loader | None = None
        self.token_type_ranges: dict[str, tuple[int, int]] | None = None

        # Geometry
        self.geometry: TrainingGeometry | None = None
        self.world_size: int | None = None

        # Training counters (host mirrors of device state)
        self.global_step: int = 0
        # Accumulation windows consumed, INCLUDING zero-token windows that apply no
        # optimizer update: the resume data position derives from this, not from
        # global_step, so skipped windows cannot desynchronize step-to-data mapping.
        self.consumed_windows: int = 0
        self.consumed_samples: int = 0
        self.tokens_train_total: int = 0
        self.token_type_counts_total: defaultdict[str, int] = defaultdict(int)
        self.wall_clock_offset: float = 0.0

        # Timing
        self.t_train_start: float = 0.0
        self.t_step_start: float = 0.0
        self._grad_norm: float | None = None

        # Optional loss log for equivalence testing (ref: ssi/trainer.py:193)
        self._loss_log: list[float] | None = None

        # Async checkpoint write (at most one in flight)
        self._save_executor = None
        self._save_future = None

    # === Setup ===

    def setup(self) -> "Trainer":
        validate_train_cfg(self.cfg)
        self._set_host_seed()
        self.dtype = _DTYPES[self.cfg.dtype]
        # Multi-host: bring up the jax.distributed runtime BEFORE any device or
        # process queries (ref gap: ssi/trainer.py:207 — scaffolded, never called).
        initialize_distributed(self.cfg.get("parallel"))
        self.world_size = jax.process_count()
        self.rank = jax.process_index()

        self._setup_mesh()
        self._setup_logging()
        self._setup_model()
        self._setup_tokenizer()
        self._extract_resume_state()
        self._setup_optimizer()
        self._setup_data()
        self.geometry = TrainingGeometry.from_config(self.cfg, self.data_train, self.world_size)
        self._finalize_resume()
        self._build_steps()
        self._resume_rng_state = self._resume_state.pop("rng_state", None) if self._resume_state else None
        self._resume_state = None
        return self

    def _set_host_seed(self) -> None:
        """Seed host RNGs (python + numpy). Data-order randomness is independently
        keyed per sample/epoch, so this guards only incidental host randomness
        (ref: torchtune training.set_seed at ssi/trainer.py:204)."""
        import random

        random.seed(SEED)
        np.random.seed(SEED % (2**32))

    def _setup_mesh(self) -> None:
        pcfg = self.cfg.get("parallel")
        dp = pcfg.get("dp") if pcfg is not None else None
        tp = int(pcfg.get("tp", 1)) if pcfg is not None else 1
        self._fsdp = bool(pcfg.get("fsdp", False)) if pcfg is not None else False
        # fsdp shards params AND moments over dp (ZeRO-3 superset of ZeRO-1)
        self._zero1 = self._fsdp or (bool(pcfg.get("zero1", False)) if pcfg is not None else False)
        self.mesh = make_mesh(dp=dp, tp=tp)
        LOGGER.info(
            f"Device mesh: dp={self.mesh.shape['dp']} tp={self.mesh.shape['tp']}"
            + (" (fsdp: dp-sharded params+moments)" if self._fsdp else " (ZeRO-1 optimizer sharding)" if self._zero1 else "")
        )

    def _setup_logging(self) -> None:
        tags = [__version__, self.cfg.config_name]
        if os.getenv("SLURM_JOB_QOS") == "gpu-debug":
            tags += [DEBUGGING_TAG]
        if self.rank != 0:
            # Non-zero ranks keep an in-memory history but never touch W&B or the
            # shared metrics/log files (rank-0-writes convention).
            from ssi_jax.train.metric_logging import JsonlLogger

            self.metric_logger = JsonlLogger(log_dir=None)
            if self.cfg.checkpointer.get("output_dir") is None:
                raise ValueError(
                    "Multi-process training requires an explicit checkpointer.output_dir "
                    "(W&B-run-derived resolution is only deterministic on rank 0)."
                )
            return
        self.metric_logger = setup_metric_logger(self.cfg.get("wandb"), tags=tags)
        if self.cfg.checkpointer.get("output_dir") is None:
            if self.world_size > 1:
                raise ValueError(
                    "Multi-process training requires an explicit checkpointer.output_dir "
                    "(W&B-run-derived resolution is only deterministic on rank 0)."
                )
            self.cfg.checkpointer.output_dir = str(resolve_checkpointer_output_dir(self.cfg, self.metric_logger))
            LOGGER.info(f"No checkpointer output dir provided. Resolved to: {self.cfg.checkpointer.output_dir}")
        if hasattr(self.metric_logger, "set_log_dir"):
            self.metric_logger.set_log_dir(self.cfg.checkpointer.output_dir)
        from ssi_jax.train.metric_logging import configure_job_logging

        configure_job_logging(self.cfg, self.cfg.checkpointer.output_dir, job_name=str(self.cfg.config_name))

    def _setup_model(self) -> None:
        self._llama_config = copy.deepcopy(get_model_config(self.cfg.get("model_config", "llama3_2_1b")))
        self._llama_config.update_from_speech_cfg(self.cfg.speech)
        ckpt_cfg = {k: v for k, v in self.cfg.checkpointer.items()}
        self.checkpointer = Checkpointer(
            **ckpt_cfg, model_expectations=self._llama_config.checkpoint_expectations
        )
        host_params = self.checkpointer.load_params(self._llama_config, dtype=self.dtype)
        params = shard_params(self.mesh, host_params, fsdp=self._fsdp)
        self.state = {"params": params, "opt_state": None, "step": jnp.zeros((), jnp.int32)}

    def _setup_tokenizer(self) -> None:
        tok_cfg = {k: v for k, v in self.cfg.tokenizer.items()}
        self.tokenizer, _special_tokens = setup_llama3_tokenizer(**tok_cfg)
        self.token_type_ranges = get_token_type_ranges(llama_config=self._llama_config)

    def _extract_resume_state(self) -> None:
        self._resume_state: dict[str, Any] | None = None
        training_state = self.checkpointer.load_training_state()
        if training_state is not None:
            self._resume_state = resume_training_state(training_state)
            self.global_step = int(self._resume_state["global_step"])
            self.consumed_samples = int(self._resume_state["consumed_samples"])

    def _setup_optimizer(self) -> None:
        self.opt_cfg = AdamWConfig.from_cfg(self.cfg.optimizer)
        self.lr_schedule = setup_lr_schedule(self.cfg, num_training_steps=self.cfg.max_steps)
        params = self.state["params"]
        shardings = opt_state_shardings(self.mesh, params, zero1=self._zero1)
        if self._resume_state is not None:
            host_opt = self._resume_state["optimizer_state"]
            from ssi_jax.checkpoint.orbax_io import is_orbax_marker, restore_opt_state

            if is_orbax_marker(host_opt):
                opt_state = restore_opt_state(
                    host_opt,
                    Path(self.checkpointer.training_state_checkpoint).parent,
                    params,
                    self.opt_cfg,
                    shardings,
                )
            else:
                opt_state = jax.tree.map(
                    lambda x, s: jax.device_put(jnp.asarray(x), s),
                    host_opt,
                    shardings,
                    is_leaf=lambda x: isinstance(x, (np.ndarray, jnp.ndarray, int, float)),
                )
            self.state["opt_state"] = opt_state
            self.state["step"] = jnp.asarray(self.global_step, jnp.int32)
        else:
            with self.mesh:
                self.state["opt_state"] = jax.jit(
                    lambda p: init_opt_state(p, self.opt_cfg),
                    out_shardings=shardings,
                )(params)

    def _setup_data(self) -> None:
        rank = jax.process_index()
        if self.cfg.config_name == "sft":
            self.data_train, self.sampler_train = setup_sft_data(
                self.cfg.data.train, self.tokenizer, num_replicas=self.world_size, rank=rank
            )
            self.data_dev, _ = setup_sft_data(
                self.cfg.data.dev, self.tokenizer, num_replicas=self.world_size, rank=rank
            )
        elif self.cfg.config_name == "cpt":
            self.data_train, self.sampler_train = setup_text_completion_data(
                self.cfg.data.train, self.tokenizer, num_replicas=self.world_size, rank=rank
            )
            self.data_dev, _ = setup_text_completion_data(
                self.cfg.data.dev, self.tokenizer, num_replicas=self.world_size, rank=rank
            )
        else:
            raise NotImplementedError(f"Unsupported config_name: {self.cfg.config_name}")

    def _finalize_resume(self) -> None:
        if self._resume_state is None:
            return
        cm = self._resume_state["cumulative_metrics"]
        # Older states without the counter: every window applied, so it equals global_step.
        self.consumed_windows = int(cm.get("consumed_windows", self.global_step))
        self.tokens_train_total = int(cm["tokens_train_total"])
        for k, v in cm["token_type_counts"].items():
            self.token_type_counts_total[k] = int(v)
        self.wall_clock_offset = float(cm["wall_clock_seconds"])
        validate_resume_hparams(
            ckpt_hparams=self._resume_state["training_hparams"],
            current_hparams=self._current_hparams(),
            force_resume=bool(self.cfg.get("force_resume", False)),
        )

    def _current_hparams(self) -> dict[str, Any]:
        return {
            "batch_size": self.geometry.batch_size,
            "gradient_accumulation_steps": self.cfg.gradient_accumulation_steps,
            "world_size": self.world_size,
            "steps_per_epoch": self.geometry.steps_per_epoch,
        }

    def _build_steps(self) -> None:
        dp = self.mesh.shape["dp"]
        if dp % self.world_size != 0:
            raise ValueError(
                f"dp mesh size ({dp}) must be divisible by the process count ({self.world_size}) "
                "so every process contributes whole batch shards."
            )
        local_dp = dp // self.world_size
        if self.geometry.batch_size % local_dp != 0:
            raise ValueError(
                f"Per-process batch_size ({self.geometry.batch_size}) must be divisible by the "
                f"per-process data-parallel share (dp={dp} / {self.world_size} processes = {local_dp}) "
                "so every device gets an equal batch shard."
            )
        attn_impl = self.cfg.get("attn_impl", "auto")
        chunk_size = int(self.cfg.get("loss_chunk_size", 1024))
        accum_dtype = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[self.cfg.get("grad_accum_dtype", "fp32")]
        self.train_step = make_train_step(
            self._llama_config,
            self.opt_cfg,
            self.lr_schedule,
            clip_grad_norm=self.cfg.get("clip_grad_norm"),
            token_type_ranges=self.token_type_ranges,
            pad_id=self.tokenizer.pad_id,
            attn_impl=attn_impl,
            remat=self.cfg.get("remat", True),  # bool or a REMAT_POLICIES name
            chunk_size=chunk_size,
            grad_accum_dtype=accum_dtype,
            deterministic=bool(self.cfg.get("deterministic_ops", False)),
            state_shardings=(
                {
                    "params": param_shardings(self.mesh, self.state["params"], fsdp=self._fsdp),
                    "opt_state": opt_state_shardings(self.mesh, self.state["params"], zero1=True),
                }
                if self._zero1
                else None
            ),
        )
        self.eval_step = make_eval_step(self._llama_config, attn_impl=attn_impl, chunk_size=chunk_size)
        self._batch_sharding = batch_sharding(self.mesh, accum_axis=True)
        self._eval_sharding = batch_sharding(self.mesh, accum_axis=False)

    # === Training ===

    def train(self) -> None:
        self.t_train_start = time.perf_counter()
        self.t_step_start = time.perf_counter()

        epochs_run = self.consumed_windows // self.geometry.steps_per_epoch
        batches_to_skip = (self.consumed_windows % self.geometry.steps_per_epoch) * self.cfg.gradient_accumulation_steps

        if getattr(self, "_resume_rng_state", None) is not None:
            restore_rng_states(self._resume_rng_state)
            LOGGER.info("Restored framework RNG states from checkpoint.")
            self._resume_rng_state = None

        from ssi_jax.config import to_yaml

        LOGGER.info(to_yaml(self.cfg, resolve=True))
        self.metric_logger.log_config(self.cfg, checkpoint_dir=self.cfg.checkpointer.output_dir)

        for epoch in range(epochs_run, self.geometry.n_epochs):
            self._train_epoch(epoch, batches_to_skip if epoch == epochs_run else 0)
            if self.global_step >= self.cfg.max_steps:
                self._save_final_checkpoint()
                LOGGER.info("Training completed.")
                return
        self._save_final_checkpoint()

    def _save_final_checkpoint(self) -> None:
        """Save the run's end state when max_steps isn't a save_steps multiple —
        otherwise up to save_steps-1 steps of progress (the run's end product)
        would silently be discarded. (The reference never reaches max_steps —
        its runs die on the Slurm limit and resume — so it has no such save.)"""
        if self.global_step != 0 and self.global_step % self.cfg.save_steps != 0:
            self.save_checkpoint()
            LOGGER.info(f"Final checkpoint saved at step {self.global_step}")

    def _train_epoch(self, epoch: int, batches_to_skip: int = 0) -> None:
        if self.sampler_train is not None:
            self.sampler_train.set_epoch(epoch)
        if hasattr(self.data_train.dataset, "set_epoch"):
            self.data_train.dataset.set_epoch(epoch)

        if batches_to_skip > 0:
            LOGGER.info(f"Resuming: skipping {batches_to_skip} batches in epoch {epoch}")
        data_iter = itertools.islice(enumerate(self.data_train), batches_to_skip, self.geometry.usable_batches)

        # overlap_io keeps ONE dispatched window in flight: window N computes on
        # device while the host tokenizes/stacks/uploads window N+1, and the
        # metrics sync for N happens only after N+1 is queued — the device never
        # idles on host data work. Metric/counter/checkpoint processing stays in
        # strict window order, so every logged value is identical to the
        # synchronous loop (only the duration_step attribution changes: it
        # measures the pipelined processing-to-processing time).
        overlap = bool(self.cfg.get("overlap_io", True))
        accum = self.cfg.gradient_accumulation_steps
        window: list[dict[str, Any]] = []
        pending: dict[str, Any] | None = None
        for i, batch in data_iter:
            window.append(batch)
            if len(window) != accum:
                continue
            if pending is not None and self._pending_needs_state():
                # the in-flight window's processing reads post-step device state
                # (eval / checkpoint / final step) — the next dispatch would
                # donate those buffers, so complete it first
                self._process_window(pending)
                pending = None
                if self.global_step >= self.cfg.max_steps:
                    return
            nxt = self._dispatch_window(epoch, i, window, in_flight=int(pending is not None))
            window = []
            if pending is not None:
                self._process_window(pending)
                pending = None
            if overlap:
                pending = nxt
            else:
                self._process_window(nxt)
            if self.global_step >= self.cfg.max_steps:
                break
        if pending is not None:
            self._process_window(pending)

    def _stack_window(self, window: list[dict[str, Any]]) -> dict[str, np.ndarray]:
        """Stack accumulation-window micro-batches to [A, B, S] (pad to window max)."""
        s_max = max(b["tokens"].shape[1] for b in window)
        pad_id = self.tokenizer.pad_id
        from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX

        def pad_to(arr: np.ndarray, value: int) -> np.ndarray:
            if arr.shape[1] == s_max:
                return arr
            out = np.full((arr.shape[0], s_max), value, dtype=arr.dtype)
            out[:, : arr.shape[1]] = arr
            return out

        pad_values = {"tokens": pad_id, "labels": CROSS_ENTROPY_IGNORE_IDX, "segment_ids": 0, "positions": 0}
        keys = ["tokens", "labels"] + [k for k in ("segment_ids", "positions") if k in window[0]]
        return {k: np.stack([pad_to(b[k], pad_values[k]) for b in window]) for k in keys}

    def _maybe_profile(self, dispatched_step: int) -> None:
        """Opt-in jax.profiler trace window (a superset of the reference's step-timing
        observability — SURVEY.md §5). Config: ``profiler: {start_step, num_steps, dir}``.

        ``dispatched_step`` is the step count at the moment of dispatch INCLUDING
        any window still in flight under overlap_io, so the trace covers the same
        optimizer steps whether or not the input pipeline is overlapped."""
        pcfg = self.cfg.get("profiler")
        if pcfg is None:
            return
        start = int(pcfg.get("start_step", 5))
        num = int(pcfg.get("num_steps", 3))
        if dispatched_step == start:
            trace_dir = str(pcfg.get("dir") or Path(self.cfg.checkpointer.output_dir) / "profile")
            jax.profiler.start_trace(trace_dir)
            self._profiling = True
            LOGGER.info(f"jax.profiler trace started -> {trace_dir}")
        elif getattr(self, "_profiling", False) and dispatched_step >= start + num:
            jax.profiler.stop_trace()
            self._profiling = False
            LOGGER.info("jax.profiler trace stopped")

    def _pending_needs_state(self) -> bool:
        """True when the in-flight window's processing may read the post-step
        device state — dev-set eval, checkpoint save, or the run's final step —
        so it must complete BEFORE the next dispatch donates those buffers."""
        ps = self.global_step + 1  # the step the pending window becomes (if applied)
        return (
            ps % self.cfg.eval_steps == 0
            or ps % self.cfg.save_steps == 0
            or ps >= self.cfg.max_steps
        )

    def _dispatch_window(
        self, epoch: int, iter_idx: int, window: list[dict[str, Any]], in_flight: int = 0
    ) -> dict[str, Any]:
        """Stack + upload one accumulation window and dispatch the jitted step
        (async). Returns the handle record ``_process_window`` consumes; only
        ``state`` is donated by the step, so the metrics outputs stay valid
        while a newer window computes. ``in_flight`` counts dispatched-but-
        unprocessed windows (0 or 1 under overlap_io) so step-indexed triggers
        like the profiler see the would-be step of THIS window."""
        self._maybe_profile(self.global_step + in_flight)
        stacked = self._stack_window(window)
        put = {k: host_local_to_global(v, self._batch_sharding) for k, v in stacked.items()}
        self.state, metrics = self.train_step(
            self.state, put["tokens"], put["labels"], put.get("segment_ids"), put.get("positions")
        )
        return {
            "epoch": epoch,
            "iter_idx": iter_idx,
            "metrics": metrics,
            "max_seq_len": int(stacked["tokens"].shape[-1]),
        }

    def _optimizer_step(self, epoch: int, iter_idx: int, window: list[dict[str, Any]]) -> None:
        """Synchronous dispatch + process (the reference's step shape;
        kept as the unit-test surface — tests drive this directly)."""
        self._process_window(self._dispatch_window(epoch, iter_idx, window))

    def _process_window(self, pending: dict[str, Any]) -> None:
        epoch, iter_idx = pending["epoch"], pending["iter_idx"]
        metrics = pending["metrics"]

        # Host sync point (one per optimizer step)
        self.consumed_windows += 1
        loss_sum = float(metrics["loss_sum"])
        num_tokens_step = int(metrics["num_tokens"])
        applied = bool(metrics["applied"])
        self._grad_norm = float(metrics["grad_norm"])
        self._last_lr = float(metrics["lr"])
        if "token_counts" in metrics:
            for tt, cnt in metrics["token_counts"].items():
                self.token_type_counts_total[tt] += int(cnt)

        if not applied:
            LOGGER.warning("No non-ignored tokens in accumulation window; skipping optimizer step.")
            self.t_step_start = time.perf_counter()
            return

        self.global_step += 1
        self.consumed_samples += self.cfg.gradient_accumulation_steps * self.geometry.batch_size * self.world_size
        loss_to_log = loss_sum / num_tokens_step
        self.tokens_train_total += num_tokens_step
        self._num_tokens_step = num_tokens_step
        self._max_seq_len_step = pending["max_seq_len"]

        if self._loss_log is not None:
            self._loss_log.append(loss_to_log)

        self._log_metrics(epoch, iter_idx, loss_to_log)
        self.t_step_start = time.perf_counter()
        self._maybe_save_checkpoint()

    def _evaluate(self) -> float:
        from ssi_jax.constants import CROSS_ENTROPY_IGNORE_IDX

        local_dp = self.mesh.shape["dp"] // self.world_size
        fills = {
            "tokens": self.tokenizer.pad_id,
            "labels": CROSS_ENTROPY_IGNORE_IDX,
            "segment_ids": 0,
            "positions": 0,
        }

        def put_batch(batch):
            keys = ["tokens", "labels"] + [k for k in ("segment_ids", "positions") if k in batch]
            rows = batch["tokens"].shape[0]
            # final partial batch: pad local rows so the per-process dp share divides
            # (the Sampler wrap-pads ranks to equal counts, so rows match across processes)
            target = ((rows + local_dp - 1) // local_dp) * local_dp
            out = []
            for k in keys:
                arr = batch[k]
                if rows != target:
                    pad = np.full((target - rows, arr.shape[1]), fills[k], arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
                out.append(host_local_to_global(arr, self._eval_sharding))
            return tuple(out)

        return compute_dataset_loss(
            self.eval_step, self.state["params"], self.data_dev, put_batch=put_batch, log_every=10
        )

    def _log_metrics(self, epoch: int, iter_idx: int, loss_to_log: float) -> None:
        LOGGER.info(
            " | ".join(
                (
                    f"Epoch {epoch + 1:03d}",
                    f"Iteration {iter_idx:0{len(str(self.geometry.batches_per_epoch))}d}"
                    f" / {self.geometry.batches_per_epoch}",
                    f"Global Step {self.global_step}",
                    f"Loss: {loss_to_log:.4f}",
                    f"Tokens (num_tokens_step): {self._num_tokens_step}",
                )
            )
        )

        # Step duration excludes the dev-set evaluation below (else eval steps log
        # wildly inflated duration_step / deflated tokens_per_second).
        dur_step = time.perf_counter() - self.t_step_start

        if self.global_step % self.cfg.eval_steps == 0:
            dev_loss = self._evaluate()
        else:
            dev_loss = None

        if self.global_step % self.cfg.log_interval == 0:
            n_chips = self.mesh.devices.size
            log_dict = {
                "loss": loss_to_log,
                "lr": self._last_lr,
                "duration_step": dur_step,
                "tokens_per_second_per_gpu": self._num_tokens_step / dur_step / n_chips,
                "tokens_total": self.tokens_train_total,
                "train_clock_time": (self.wall_clock_offset + (time.perf_counter() - self.t_train_start)) / (60**2),
                "max_seq_len_step": self._max_seq_len_step,
                **{f"n_tokens.{tt}": ttcnt for tt, ttcnt in self.token_type_counts_total.items()},
            }
            if self.cfg.get("clip_grad_norm") is not None:
                log_dict.update({"grad_norm": self._grad_norm})
            if dev_loss is not None:
                log_dict.update({"dev_loss": dev_loss})
            self.metric_logger.log_dict(log_dict, step=self.global_step)
        elif dev_loss is not None:
            # eval step that isn't a log-interval step: never discard a computed dev loss
            self.metric_logger.log_dict({"dev_loss": dev_loss}, step=self.global_step)

    def _maybe_save_checkpoint(self) -> None:
        if self.global_step != 0 and self.global_step % self.cfg.save_steps == 0:
            self.save_checkpoint()
            LOGGER.info(f"Checkpoint saved at step {self.global_step}")

    # === Checkpointing ===

    def save_checkpoint(self) -> None:
        """Save HF-format model weights + schema-v1 training state
        (ref: ssi/trainer.py:494-514).

        With ``async_save: true`` (a feature the reference only planned —
        plans/Checkpointing - Consolidated Plan.md F5), the device->host transfer
        and RNG capture happen synchronously, then serialization/disk IO run on a
        background thread overlapped with training. At most one save is in flight;
        a new save (or cleanup) joins the previous one first.
        """
        from ssi_jax.checkpoint import save_rng_states

        self._join_pending_save()
        # Cross-host-sharded state is not fully addressable: all ranks join the
        # all-gather (a collective), then only rank 0 touches the filesystem.
        host_params = full_host_copy(self.state["params"], self.mesh)
        rng_state = save_rng_states()
        step = self.global_step
        sharded_opt = bool(self.cfg.get("sharded_optimizer_state", False))
        if sharded_opt:
            # Orbax sharded save: every process writes its own shards in
            # parallel (collective — must run on the training thread, not the
            # async-save worker); msgpack stores only a directory marker.
            from ssi_jax.checkpoint.orbax_io import save_opt_state

            host_opt = save_opt_state(
                self.state["opt_state"], Path(self.checkpointer.output_dir), step
            )
        else:
            host_opt = full_host_copy(self.state["opt_state"], self.mesh)
        kwargs = dict(
            optimizer_state=host_opt,
            lr_scheduler_state={"last_step": step},
            global_step=step,
            seed=SEED,
            training_hparams=self._current_hparams(),
            consumed_samples=self.consumed_samples,
            cumulative_metrics={
                "tokens_train_total": self.tokens_train_total,
                "token_type_counts": dict(self.token_type_counts_total),
                "wall_clock_seconds": self.wall_clock_offset + (time.perf_counter() - self.t_train_start),
                "consumed_windows": self.consumed_windows,
            },
            rng_state=rng_state,
        )

        def write():
            if self.rank != 0:
                return
            self.checkpointer.save_model_checkpoint(host_params, self._llama_config, step)
            self.checkpointer.save_training_state(**kwargs)
            self._prune_checkpoints(keep_step=step)
            if sharded_opt:
                from ssi_jax.checkpoint.orbax_io import prune_old_opt_states

                # only after the state msgpack referencing `step` is on disk
                prune_old_opt_states(Path(self.checkpointer.output_dir), keep_step=step)

        if bool(self.cfg.get("async_save", False)):
            import concurrent.futures

            if self._save_executor is None:
                self._save_executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._save_future = self._save_executor.submit(write)
        else:
            write()

    def _join_pending_save(self) -> None:
        if getattr(self, "_save_future", None) is not None:
            self._save_future.result()  # surface exceptions from the background write
            self._save_future = None

    def _prune_checkpoints(self, keep_step: int) -> None:
        """Retention policy: keep only the newest N step dirs (the reference's
        planned-but-unbuilt F4; null/absent = keep everything)."""
        keep_n = self.cfg.get("keep_last_n_checkpoints")
        if not keep_n:
            return
        import shutil

        root = Path(self.cfg.checkpointer.output_dir)
        # the dir training loaded from is the source every save copies configs
        # out of — pruning it (e.g. resuming from an older step_N in this same
        # output dir) would crash every subsequent save
        src_dir = Path(self.cfg.checkpointer.checkpoint_dir).resolve()
        step_dirs = []
        for p in root.glob("step_*"):
            try:
                step_dirs.append((int(p.name.removeprefix("step_")), p))
            except ValueError:
                continue
        step_dirs.sort(reverse=True)
        for step_num, p in step_dirs[int(keep_n):]:
            if step_num == keep_step or p.resolve() == src_dir:
                continue
            shutil.rmtree(p, ignore_errors=True)
            LOGGER.info(f"Pruned old checkpoint {p} (keep_last_n_checkpoints={keep_n})")

    # === Cleanup ===

    def cleanup(self) -> None:
        self._join_pending_save()
        if getattr(self, "_save_executor", None) is not None:
            self._save_executor.shutdown(wait=True)
            self._save_executor = None
        if self.metric_logger is not None:
            self.metric_logger.close()
