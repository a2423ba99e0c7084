#!/usr/bin/env python
"""Per-op device-time profile of the headline CPT train step.

Traces a few optimizer steps with jax.profiler, then parses the xplane with
tensorboard_plugin_profile and prints the top ops by self time as JSONL —
the attributable step-time decomposition the ROADMAP's perf levers come
from. Usage:

    python tools/profile_train.py [--shape cpt|sft] [--top 40]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import ssi_jax  # noqa: E402,F401  (the package's one compile-cache location)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="cpt", choices=["cpt", "sft"])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--logdir", default="/tmp/ssi_profile")
    args = ap.parse_args()

    import bench

    shape = bench.CPT_SHAPE if args.shape == "cpt" else bench.SFT_SHAPE
    # timed_ctx scopes the trace to the timed loop only: param/optimizer init,
    # compile, and bench's internal warmup steps all run before the trace opens,
    # so the per-op table is steady-state steps and nothing else
    bench._measure(shape, steps=args.steps, timed_ctx=jax.profiler.trace(args.logdir))

    xplanes = sorted(glob.glob(os.path.join(args.logdir, "**", "*.xplane.pb"), recursive=True))
    if not xplanes:
        print(json.dumps({"error": "no xplane captured (device tracing unsupported?)"}))
        return
    xplane = xplanes[-1]

    from tensorboard_plugin_profile.convert import raw_to_tool_data as convert

    # hlo (framework) op stats: one row per fused HLO op with self/total time
    data, _ = convert.xspace_to_tool_data([xplane], "framework_op_stats^", {})
    table = json.loads(data) if isinstance(data, (str, bytes)) else data
    # gviz table json: {cols: [...], rows: [{c: [{v: ...}, ...]}]}
    cols = [c["label"] for c in table[0]["cols"]] if isinstance(table, list) else [c["label"] for c in table["cols"]]
    rows = table[0]["rows"] if isinstance(table, list) else table["rows"]

    def col(*names):
        # most-specific candidate first ("total self-time" before bare "self"):
        # plugin versions relabel/reorder columns, substring match on the first
        # candidate that resolves keeps the lookup stable
        for name in names:
            for i, c in enumerate(cols):
                if name.lower() in c.lower():
                    return i
        return None

    i_name = col("operation", "op name")
    i_self = col("total self", "avg. self", "self")
    i_occ = col("occurrences", "#occur")

    def as_float(v):
        try:
            return float(v)
        except (TypeError, ValueError):  # formatted-string cells in some plugin versions
            return 0.0

    out = []
    for r in rows:
        vals = [c.get("v") if isinstance(c, dict) else c for c in r["c"]]
        out.append(
            {
                "op": vals[i_name] if i_name is not None else vals[0],
                "self_us": as_float(vals[i_self]) if i_self is not None else None,
                "n": vals[i_occ] if i_occ is not None else None,
            }
        )
    out.sort(key=lambda d: -as_float(d["self_us"]))
    print(json.dumps({"columns": cols}))
    for d in out[: args.top]:
        print(json.dumps(d))


if __name__ == "__main__":
    main()
