"""Render roofline tables from dry-run JSON records (port of
``repro/roofline/report.py``; pure Python).

  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_single.json

Left out: nothing.  The records come from the port's dry run
(``launch/dryrun.py``, ``--out``).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL/HLO | roofline frac | bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skip | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | FAIL | | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'].split('_')[0]} | {r['model_hlo_ratio']:.2f} | "
            f"{r['roofline_frac_overlap']:.3f} | "
            f"{r['bytes_per_device']/2**30:.1f} GiB |")
    return "\n".join(lines)


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | flops/dev | bytes/dev | "
        "AG | AR | RS | A2A | CP |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            why = r.get("why", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r['status']}: {why} | | | | | | | |")
            continue
        c = r["collectives"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['flops_per_device']:.2e} | "
            f"{r['bytes_per_device']/2**30:.1f} GiB | "
            f"{c['all-gather']/2**30:.2f} | {c['all-reduce']/2**30:.2f} | "
            f"{c['reduce-scatter']/2**30:.2f} | {c['all-to-all']/2**30:.2f} | "
            f"{c['collective-permute']/2**30:.2f} |")
    return "\n".join(lines)


def main():
    for path in sys.argv[1:]:
        recs = json.load(open(path))
        print(f"### {path}\n")
        print(roofline_table(recs))
        print()


if __name__ == "__main__":
    main()
