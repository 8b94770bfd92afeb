"""The crash-isolated dry-run sweep, the counterpart of
``repro.launch.dryrun_sweep``.

Each (arch, shape, world) combination runs ``repro_torch.launch.dryrun`` in
its own subprocess with a timeout, so a crash or a trace that runs away is
recorded as a JSON failure record instead of ending the sweep.  ``--jobs``
runs that many subprocesses at once (the traces are single-threaded).

  python -m repro_torch.launch.dryrun_sweep --out D --mesh both --device cpu --jobs 8
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
import json
import os
import subprocess
import sys
import time

from ..configs import INPUT_SHAPES, list_archs
from .dryrun import MESHES


def run_combo(arch, shape, mesh_tag, compressor, interval, out_dir, timeout,
              device="cuda"):
    tag = f"{arch}__{shape}__{mesh_tag}__{compressor}"
    path = os.path.join(out_dir, tag + ".json")
    cmd = [
        sys.executable, "-m", "repro_torch.launch.dryrun",
        "--arch", arch, "--shape", shape, "--mesh", mesh_tag,
        "--compressor", compressor, "--out", out_dir, "--device", device,
    ]
    if interval is not None:
        cmd += ["--interval", str(interval)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                              env={**os.environ})
        if proc.returncode != 0 and not os.path.exists(path):
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh_tag,
                "compressor": compressor, "status": "crash",
                "returncode": proc.returncode,
                "stderr_tail": proc.stderr[-3000:],
                "wall_s": round(time.perf_counter() - t0, 1),
            }
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            return "CRASH", tag
    except subprocess.TimeoutExpired:
        rec = {
            "arch": arch, "shape": shape, "mesh": mesh_tag,
            "compressor": compressor, "status": "timeout",
            "timeout_s": timeout,
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return "TIMEOUT", tag
    try:
        with open(path) as f:
            rec = json.load(f)
        return {"ok": "OK", "does_not_fit": "NOFIT"}.get(rec.get("status"), "FAIL"), tag
    except FileNotFoundError:
        return "MISSING", tag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="both", choices=["w8", "2x8", "both"])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--compressor", default="covap")
    ap.add_argument("--interval", type=int, default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, one subprocess each")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs(assigned_only=True) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    combos = []
    for arch in archs:
        for shape in shapes:
            for mesh_tag in meshes:
                tag = f"{arch}__{shape}__{mesh_tag}__{args.compressor}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    try:
                        with open(path) as f:
                            st = json.load(f).get("status")
                    except (OSError, ValueError):
                        st = None
                    if st in ("ok", "does_not_fit"):
                        print(f"skip {tag}", flush=True)
                        continue
                combos.append((arch, shape, mesh_tag))

    def one(combo):
        status, tag = run_combo(*combo, args.compressor, args.interval, args.out,
                                args.timeout, device=args.device)
        print(f"{status:8s} {tag}", flush=True)
        return status, tag

    with ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as pool:
        results = list(pool.map(one, combos))
    bad = [t for s, t in results if s not in ("OK", "NOFIT")]
    print(f"\n{len(results)} run, {len(bad)} not-OK")
    for t in bad:
        print("  ", t)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
