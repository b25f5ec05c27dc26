"""Roofline report: merged dry-run JSONs → markdown tables.

    PYTHONPATH=src python -m repro_torch.roofline.report build/dryrun_*.json

The reference's tables on the port's records (`launch/dryrun.py`). The
one wording that differs is `advice()` for a compute-bound cell: the
H100's matrix units are tensor cores, so it says "tensor-core-align
shapes" where the reference says "MXU-align shapes". Records that
carry the port's `fallbacks` (the ops DTensor could not place as the
rules do, see `launch/dryrun.CostMode`) get one more table,
`fmt_fallback_table`; the reference's records have none.
"""
from __future__ import annotations

import glob
import json
import sys
from typing import Dict, List


def load_records(patterns: List[str]) -> List[Dict]:
    seen: Dict = {}
    for pat in patterns:
        for f in sorted(glob.glob(pat)):
            with open(f) as fh:
                records = json.load(fh)
            for r in records:
                key = (r["arch"], r["shape"], r["mesh"],
                       r.get("remat", "full"))
                # latest occurrence wins (reruns append)
                if key not in seen or r.get("ok"):
                    seen[key] = r
    return list(seen.values())


def fmt_table(records: List[Dict], mesh: str = "single") -> str:
    rows = [r for r in records if r.get("ok") and r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute_ms | memory_ms | collective_ms | "
           "dominant | useful | roofline_frac | what moves it down |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']*1e3:.1f} | "
            f"{r['memory_s']*1e3:.1f} | {r['collective_s']*1e3:.1f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {advice(r)} |")
    return "\n".join(out)


def advice(r: Dict) -> str:
    d = r["dominant"]
    if d == "collective":
        kinds = r.get("coll_bytes_per_device", {})
        big = max(kinds, key=kinds.get) if kinds else "?"
        return f"cut {big} volume (resharding/overlap)"
    if d == "memory":
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return "KV layout: avoid reshard copies; fuse cache update"
        return "fusion/remat policy; avoid replicate-repartition copies"
    return "tensor-core-align shapes; drop padding waste"


def fmt_dryrun_table(records: List[Dict]) -> str:
    rows = sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = ["| arch | shape | mesh | ok | compile_s | args_GB/dev | "
           "temp_GB/dev | flops/dev | coll_GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("ok"):
            ma = r.get("memory_analysis", {})
            coll = sum(r.get("coll_bytes_per_device", {}).values())
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ✓ | "
                f"{r.get('compile_s','')} | "
                f"{ma.get('argument_size_in_bytes',0)/1e9:.2f} | "
                f"{ma.get('temp_size_in_bytes',0)/1e9:.2f} | "
                f"{r['flops_per_device']:.2e} | {coll/1e9:.2f} |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ✗ "
                       f"{r.get('error','')[:40]} | | | | | |")
    return "\n".join(out)


def fmt_fallback_table(records: List[Dict]) -> str:
    """Each ok cell's fallbacks: a count a kind, the collective bytes
    they ran, and their share of the cell's collective bytes."""
    rows = sorted((r for r in records if r.get("ok") and "fallbacks" in r),
                  key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    kinds = list(rows[0]["fallbacks"]) if rows else []
    out = ["| arch | shape | mesh | " + " | ".join(kinds)
           + " | fallback_GB/dev | share_of_coll |",
           "|---|---|---|" + "---|" * (len(kinds) + 2)]
    for r in rows:
        fb = r["fallbacks"]
        gathered = sum(f["bytes"] for f in fb.values())
        coll = sum(r.get("coll_bytes_per_device", {}).values())
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            + " | ".join(str(fb[k]["count"]) for k in kinds)
            + f" | {gathered/1e9:.2f} | "
            f"{gathered / coll if coll else 0.0:.3f} |")
    return "\n".join(out)


def main():
    pats = sys.argv[1:] or ["results/dryrun_*.json"]
    recs = load_records(pats)
    ok = [r for r in recs if r.get("ok")]
    print(f"# {len(ok)}/{len(recs)} cells ok\n")
    print("## Dry-run grid (both meshes)\n")
    print(fmt_dryrun_table(recs))
    print("\n## Roofline (single-pod, per assignment)\n")
    print(fmt_table(recs, "single"))
    print("\n## Multi-pod (512 chips)\n")
    print(fmt_table(recs, "multi"))
    if any("fallbacks" in r for r in ok):
        print("\n## Fallbacks (ops DTensor could not place as the rules "
              "do)\n")
        print(fmt_fallback_table(recs))
    if ok:
        worst = min((r for r in ok if r["mesh"] == "single"),
                    key=lambda r: r["roofline_fraction"])
        coll = max((r for r in ok if r["mesh"] == "single"),
                   key=lambda r: r["collective_s"] / max(r["step_time_s"],
                                                         1e-12))
        print(f"\nworst roofline fraction: {worst['arch']}×{worst['shape']}"
              f" ({worst['roofline_fraction']:.4f})")
        print(f"most collective-bound: {coll['arch']}×{coll['shape']}"
              f" ({coll['collective_s']/max(coll['step_time_s'],1e-12):.0%})")


if __name__ == "__main__":
    main()
