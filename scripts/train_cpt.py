#!/usr/bin/env python
"""Continued pre-training entry point (ref: scripts/train_cpt.py:1-19).

Usage: python scripts/train_cpt.py data=cpt/mls-hubert_large_ll60k-layer_22 [key=value ...]
"""

import logging
import sys

from ssi_jax.config import compose
from ssi_jax.train import Trainer
from ssi_jax.train.train_utils import resolve_n_dsus

logging.basicConfig(
    format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    level=logging.INFO,
    stream=sys.stdout,
)


def main(argv: list[str]) -> None:
    cfg = compose("conf", "cpt", overrides=argv)
    from ssi_jax.train.metric_logging import configure_hydra_logging

    configure_hydra_logging(cfg)
    resolve_n_dsus(cfg)
    trainer = Trainer(cfg)
    trainer.setup()
    trainer.train()
    trainer.cleanup()


if __name__ == "__main__":
    main(sys.argv[1:])
