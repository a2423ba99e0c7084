#!/usr/bin/env python
"""Worker process for the 2-process distributed-training validation.

Launched by tests/test_multiprocess.py (and usable manually):

    python tools/mp_worker.py --rank R --nprocs N --port P --workdir DIR \
        --steps S --batch-size B

Runs the full Trainer over a tiny model + local-JSON SFT data with
``parallel.distributed`` configured explicitly, so the exact multi-host code
path (`initialize_distributed` -> global mesh -> per-process Sampler shard ->
``make_array_from_process_local_data`` batch assembly -> rank-0 checkpoint
write) executes across real OS processes. Writes the per-step loss stream to
``DIR/losses_rank{R}.json``.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--workdir", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--overlap", action="store_true", help="run with overlap_io (pipelined input loop)")
    ap.add_argument("--tag", default="", help="suffix for output files/ckpt dir (lets sync+overlap runs share a workdir)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    # jax.distributed must come up BEFORE anything touches the XLA backend
    # (importing the data/trainer stack initializes devices); the Trainer's own
    # initialize_distributed call is idempotent and becomes a no-op.
    from ssi_jax.parallel import initialize_distributed

    dist_cfg = {
        "distributed": True,
        "coordinator_address": f"localhost:{args.port}",
        "num_processes": args.nprocs,
        "process_id": args.rank,
    }
    assert initialize_distributed(dist_cfg)

    from tests import helpers
    from ssi_jax.train import Trainer

    model_dir = args.workdir / "model"
    data_file = str(args.workdir / "data.jsonl")

    cfg = helpers.base_train_cfg_dict(model_dir, args.workdir / f"ckpt_shared{args.tag}", kind="sft")
    cfg["max_steps"] = args.steps
    cfg["save_steps"] = args.steps
    cfg["eval_steps"] = args.steps
    cfg["lr_scheduler"] = None
    cfg["overlap_io"] = bool(args.overlap)
    cfg["parallel"] = {
        "dp": args.nprocs,
        "tp": 1,
        "distributed": True,
        "coordinator_address": f"localhost:{args.port}",
        "num_processes": args.nprocs,
        "process_id": args.rank,
    }
    for split in ("train", "dev"):
        ds = cfg["data"][split]["dataset"]
        ds["source"] = "json"
        ds["data_files"] = data_file
        ds["split"] = "train"
        cfg["data"][split]["dataloader"]["batch_size"] = args.batch_size

    t = Trainer(helpers.make_cfg(cfg))
    t.setup()
    assert jax.process_count() == args.nprocs, jax.process_count()
    assert t.world_size == args.nprocs

    # record this rank's data shard for the disjointness assertion
    shard = list(iter(t.sampler_train))

    losses = []
    t._loss_log = losses
    t.train()
    t.cleanup()

    out = {
        "rank": args.rank,
        "losses": losses,
        "shard": shard,
        "consumed_samples": t.consumed_samples,
    }
    with open(args.workdir / f"losses_rank{args.rank}{args.tag}.json", "w") as f:
        json.dump(out, f)
    print(f"rank {args.rank} done: {losses}")


if __name__ == "__main__":
    main()
