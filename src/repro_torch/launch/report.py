"""Aggregate the port's dry-run jsonl records into roofline tables
(markdown to stdout), as :mod:`repro.launch.report`.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--jsonl experiments/torch_dryrun.jsonl] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import OUT


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def load(path):
    recs = []
    with open(path) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    # dedupe: keep the last record per cell
    out = {}
    for r in recs:
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return list(out.values())


def header(mesh):
    return (f"\n### Roofline — mesh {mesh} (per rank; H100 SXM, published: "
            f"{RL.PEAK_FLOPS['bfloat16'] / 1e12:.0f} TF/s bf16, "
            f"{RL.HBM_BW / 1e12:.2f} TB/s HBM, "
            f"{RL.NVLINK_BW / 1e9:.0f} GB/s NVLink, "
            f"{RL.NETWORK_BW / 1e9:.0f} GB/s network)\n")


def table(recs, mesh="16x16"):
    print(header(mesh))
    print("| arch | shape | status | compute_s | memory_s | collective_s"
          " | bottleneck | useful/HLO flops | HBM/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        if r.get("status") == "skipped":
            print(f"| {r['arch']} | {r['shape']} | skipped "
                  f"({r.get('reason','')[:40]}...) | | | | | | |")
            continue
        if r.get("status") != "ok":
            print(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
            continue
        mem = r.get("memory", {}).get("total_hbm_bytes")
        print(f"| {r['arch']} | {r['shape']} | ok "
              f"| {r['compute_s']:.3g} | {r['memory_s']:.3g} "
              f"| {r['collective_s']:.3g} | {r['bottleneck']} "
              f"| {r.get('useful_flops_ratio', 0):.2f} "
              f"| {fmt_bytes(mem)} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default=OUT)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load(args.jsonl)
    ok = sum(1 for r in recs if r.get("status") == "ok")
    sk = sum(1 for r in recs if r.get("status") == "skipped")
    er = len(recs) - ok - sk
    print(f"cells: {len(recs)} ok={ok} skipped={sk} error={er}")
    for mesh in ([args.mesh] if args.mesh else ("16x16", "2x16x16")):
        table(recs, mesh)


if __name__ == "__main__":
    main()
