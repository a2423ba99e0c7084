#!/usr/bin/env python
"""Standing completions server over a step_N checkpoint (the `vllm serve`
role; the reference delegates generation to vLLM at scripts/generate.py:112-118).

Usage: python scripts/serve.py model=/path/to/step_N [server.port=8000] [key=value ...]

Endpoints: POST /v1/completions, GET /health, GET /v1/models, GET /metrics.
Resolves speech.n_dsus from the training-config snapshot next to the
checkpoint when not given explicitly (same rule as scripts/generate.py).
"""

import logging
from pathlib import Path
import sys

from ssi_jax.config import compose, load_yaml
from ssi_jax.constants import TRAIN_CONFIG_FILENAME
from ssi_jax.serve import run_server

logging.basicConfig(
    format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    level=logging.INFO,
    stream=sys.stdout,
)

LOGGER = logging.getLogger(__name__)

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"


def main(argv: list[str]) -> None:
    cfg = compose(str(CONF_DIR), "serve", overrides=argv)

    if cfg.speech.n_dsus is None:
        train_cfg = None
        if cfg.get("train_yaml") is not None:
            train_cfg = load_yaml(cfg.train_yaml)
        else:
            for parent_idx in (0, 1):
                p = Path(cfg.model).parents[parent_idx] / TRAIN_CONFIG_FILENAME
                if p.exists():
                    train_cfg = load_yaml(p)
                    LOGGER.warning(f"Loaded training config from {p!s}")
                    break
        if train_cfg and train_cfg.get("speech", {}).get("n_dsus") is not None:
            cfg.speech.n_dsus = train_cfg["speech"]["n_dsus"]
            LOGGER.info(f"Auto-setting cfg.speech.n_dsus to {cfg.speech.n_dsus} from training config.")
        else:
            raise ValueError("cfg.speech.n_dsus must be specified via CLI or the training config snapshot.")

    run_server(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
