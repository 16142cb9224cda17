"""Run the whole (arch x shape x mesh) dry-run sweep of the port, one
subprocess per cell (``python -m repro_torch.launch.dryrun``: a fresh
process group each), resumable from the output jsonl: a cell with an
``ok`` or ``skipped`` record is done.  As
:mod:`repro.launch.sweep`.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        [--out experiments/torch_dryrun.jsonl] [--meshes single,multi]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import DONE, OUT, SWEEP_ARCHS


def _method(shape: str, method: str) -> str:
    kind = SHAPES[shape].kind
    return method if kind == "train" else kind


def done_cells(out):
    """``{(arch, shape, mesh, method)}`` of the cells ``out`` holds a
    done record of."""
    seen = set()
    if os.path.exists(out):
        with open(out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in DONE:
                    seen.add((r["arch"], r["shape"], r["mesh"],
                              r.get("method", "heron")))
    return seen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--method", default="heron")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--meshes", default="single,multi")
    args = ap.parse_args(argv)
    seen = done_cells(args.out)
    meshes = args.meshes.split(",")
    cells = [(a, s, m) for a in SWEEP_ARCHS for s in SHAPES for m in meshes]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    t_all = time.time()
    for i, (arch, shape, mesh) in enumerate(cells):
        mesh_name = "2x16x16" if mesh == "multi" else "16x16"
        if (arch, shape, mesh_name, _method(shape, args.method)) in seen:
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--method", args.method,
               "--out", args.out]
        if mesh == "multi":
            cmd.append("--multi-pod")
        t0 = time.time()
        print(f"[sweep {i+1}/{len(cells)}] {arch} {shape} {mesh_name}",
              flush=True)
        try:
            r = subprocess.run(cmd, timeout=args.timeout,
                               capture_output=True, text=True, env=env)
            tail = (r.stdout.strip().splitlines() or [""])[-1][:160]
            print(f"   -> rc={r.returncode} {time.time()-t0:.0f}s {tail}",
                  flush=True)
            if r.returncode != 0:
                err = (r.stdout + r.stderr)[-500:]
                print(f"   STDERR: {err}", flush=True)
        except subprocess.TimeoutExpired:
            print(f"   -> TIMEOUT after {args.timeout}s", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "method": _method(shape, args.method),
                    "status": "error", "error": "count timeout"}) + "\n")
    print(f"[sweep] done in {time.time() - t_all:.0f}s", flush=True)


if __name__ == "__main__":
    main()
