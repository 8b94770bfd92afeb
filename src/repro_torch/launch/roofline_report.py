"""Aggregate the dry run's records into the roofline table, the
counterpart of ``repro.launch.roofline_report``, with the port's worlds
(``w8``: one node of 8 H100s; ``2x8``: two nodes) in place of the
reference's ``16x16`` / ``2x16x16`` meshes.

    python -m repro_torch.launch.roofline_report --dir D --md roofline.md
"""
from __future__ import annotations

import argparse
import json

from .dryrun_summary import load

MESHES = ("w8", "2x8")


def fmt_ms(s):
    return f"{s*1e3:.2f}"


def one_liner(rec: dict) -> str:
    """'What would move the dominant term down' — rule-based suggestion."""
    r = rec.get("roofline", {})
    dom = r.get("dominant")
    kind = rec.get("kind")
    if dom == "collective":
        if kind == "train":
            return "raise COVAP interval / larger buckets to cut sync volume"
        return "reshard weights to cut per-step weight gathers"
    if dom == "memory":
        if kind == "decode":
            return "shrink KV reads: wider GQA sharding or quantized cache"
        return "fuse elementwise chains; bf16 activations to cut HBM traffic"
    return "fill the tensor cores: larger bf16 matmul tiles, fewer small products"


def _reported(r: dict) -> bool:
    """A record with a roofline: it traced, whether or not it fits."""
    return r.get("status") in ("ok", "does_not_fit") and "roofline" in r


def table(recs: list[dict], mesh: str) -> str:
    rows = [r for r in recs if r.get("mesh") == mesh and _reported(r)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | dom | compute ms | memory ms | collective ms | "
        "useful_flops | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rf = r["roofline"]
        ratio = rf.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['dominant'][:4]} | "
            f"{fmt_ms(rf['compute_s'])} | {fmt_ms(rf['memory_s'])} | "
            f"{fmt_ms(rf['collective_s'])} | "
            f"{ratio:.2f} | {one_liner(r)} |"
            if ratio is not None else
            f"| {r['arch']} | {r['shape']} | {rf['dominant'][:4]} | "
            f"{fmt_ms(rf['compute_s'])} | {fmt_ms(rf['memory_s'])} | "
            f"{fmt_ms(rf['collective_s'])} | n/a | {one_liner(r)} |"
        )
    return "\n".join(out)


def pick_hillclimb(recs: list[dict], mesh: str = "w8") -> dict:
    """worst roofline fraction, most collective-bound, most COVAP-representative."""
    rows = [r for r in recs if r.get("mesh") == mesh and _reported(r)]
    if not rows:
        return {}

    def frac(r):
        rf = r["roofline"]
        bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        return rf["compute_s"] / bound if bound else 0.0

    worst = min(rows, key=frac)
    coll = max(rows, key=lambda r: r["roofline"]["collective_s"] /
               max(r["roofline"]["compute_s"] + r["roofline"]["memory_s"], 1e-12))
    train = [r for r in rows if r["kind"] == "train"]
    rep = max(train, key=lambda r: r["roofline"]["collective_s"]) if train else None
    return {
        "worst_roofline_fraction": f"{worst['arch']}/{worst['shape']}",
        "most_collective_bound": f"{coll['arch']}/{coll['shape']}",
        "most_representative": f"{rep['arch']}/{rep['shape']}" if rep else None,
    }


def report(recs: list[dict]) -> str:
    parts = []
    for mesh in MESHES:
        parts.append(f"### Mesh {mesh}\n\n" + table(recs, mesh) + "\n")
    parts.append("### Hillclimb candidates (single-pod)\n")
    parts.append("```json\n" + json.dumps(pick_hillclimb(recs), indent=1) + "\n```")
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--md", default="")
    args = ap.parse_args(argv)
    text = report(load(args.dir))
    if args.md:
        with open(args.md, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
