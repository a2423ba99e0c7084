"""Training subsystem: functional core (jitted step over a device mesh) + host loop.

Layout:
- :mod:`ssi_jax.train.geometry` — batch/step/epoch arithmetic (``TrainingGeometry``).
- :mod:`ssi_jax.train.optimizer` — first-party AdamW with explicit-dtype state.
- :mod:`ssi_jax.train.lr_schedule` — pure ``step -> lr`` schedules.
- :mod:`ssi_jax.train.step` — jitted train/eval step builders (grad-accum scan).
- :mod:`ssi_jax.train.train_utils` — config validation, resume schema, token types.
- :mod:`ssi_jax.train.metric_logging` — W&B-or-JSONL metric logger.
- :mod:`ssi_jax.train.trainer` — the host-side Trainer orchestrating it all.
"""

from ssi_jax.train.geometry import TrainingGeometry  # noqa: F401
from ssi_jax.train.trainer import Trainer  # noqa: F401
