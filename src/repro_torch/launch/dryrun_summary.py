"""The dry run's evidence table: memory fit and collective plan per
combination, the counterpart of ``repro.launch.dryrun_summary``, over the
port's records (``launch.dryrun``), whose keys are the reference's.

    python -m repro_torch.launch.dryrun_summary --dir D --md summary.md

In the port's records ``collectives`` holds the plan's calls and
``compile_s`` the seconds to plan and trace the step on fake tensors (the
counterpart of XLA's compile); a record that does not fit in a card prints
its numbers, its peak marked ``DOES_NOT_FIT`` (the reference never
records one).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def gb(x):
    return f"{x/1e9:.2f}"


def load(dir_: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | peak GB/dev | args GB | AR ops/GB | "
        "AG ops/GB | A2A ops/GB | compile s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(
        recs, key=lambda r: (r.get("arch", ""), r.get("shape", ""), r.get("mesh", ""))
    ):
        if r.get("status") not in ("ok", "does_not_fit"):
            lines.append(
                f"| {r.get('arch')} | {r.get('shape')} | {r.get('mesh')} | "
                f"{r.get('status').upper()} | | | | | |"
            )
            continue
        ma = r.get("memory_analysis", {})
        coll = r.get("collectives", {}).get("by_kind", {})

        def cell(kind):
            d = coll.get(kind)
            return f"{d['count']}/{gb(d['bytes'])}" if d else "-"

        peak = gb(ma.get("peak_memory_in_bytes", 0))
        if r["status"] != "ok":
            peak += " DOES_NOT_FIT"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {peak} | "
            f"{gb(ma.get('argument_size_in_bytes', 0))} | "
            f"{cell('all-reduce')} | {cell('all-gather')} | "
            f"{cell('all-to-all')} | {r.get('compile_s', '')} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--md", default="")
    args = ap.parse_args(argv)
    text = table(load(args.dir))
    if args.md:
        with open(args.md, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
