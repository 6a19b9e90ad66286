"""The roofline table and the two "worst" lists from the dry run's JSONs
(``launch/dryrun.py``); port of ``repro/roofline/report.py``.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str, mesh: str | None = None, tag: str = ""):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        r = json.load(open(f))
        if mesh and r.get("mesh") != mesh:
            continue
        if (r.get("tag") or "") != tag:
            continue
        rows.append(r)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def table(rows, include_mesh=False):
    hdr = ["arch", "shape"]
    if include_mesh:
        hdr.append("mesh")
    hdr += ["compute", "memory", "collective", "bound", "useful_flops",
            "status"]
    lines = ["| " + " | ".join(hdr) + " |",
             "|" + "---|" * len(hdr)]
    for r in rows:
        cells = [r["arch"], r["shape"]]
        if include_mesh:
            cells.append(r["mesh"])
        if r["status"] == "ok":
            t = r["roofline"]
            cells += [fmt_s(t["compute_s"]), fmt_s(t["memory_s"]),
                      fmt_s(t["collective_s"]),
                      f"**{t['dominant']}**",
                      f"{t['useful_flops_ratio']*100:.0f}%", "ok"]
        elif r["status"] == "skipped":
            cells += ["—"] * 5 + [f"skip: {r['reason'][:40]}"]
        else:
            cells += ["—"] * 5 + ["ERROR"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    rows = load(args.dir, args.mesh, args.tag)
    print(table(rows))
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"\n{len(ok)} ok / {len(rows)} cells on {args.mesh}")
    # candidates for hillclimbing
    worst = sorted(ok, key=lambda r: r["roofline"]["useful_flops_ratio"])[:5]
    print("\nworst useful-FLOPs ratio:")
    for r in worst:
        print(f"  {r['arch']} x {r['shape']}: "
              f"{r['roofline']['useful_flops_ratio']*100:.1f}% "
              f"(bound: {r['roofline']['dominant']})")
    coll = sorted(ok, key=lambda r: -(r["roofline"]["collective_s"] /
                                      max(r["roofline"]["bound_s"], 1e-30)))[:5]
    print("\nmost collective-bound:")
    for r in coll:
        t = r["roofline"]
        print(f"  {r['arch']} x {r['shape']}: coll {fmt_s(t['collective_s'])}"
              f" vs bound {fmt_s(t['bound_s'])}")


if __name__ == "__main__":
    main()
