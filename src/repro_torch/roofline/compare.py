"""Baseline-vs-changed roofline comparison of two sets of dry-run records.

    PYTHONPATH=src python -m repro_torch.roofline.compare \
        "build/dryrun_base*.json" "build/dryrun_opt*.json"
"""
import math
import sys

from repro_torch.roofline.report import load_records


def main():
    base_pat, opt_pat = sys.argv[1], sys.argv[2]
    base = {(r["arch"], r["shape"], r["mesh"]): r
            for r in load_records([base_pat]) if r.get("ok")}
    opt = {(r["arch"], r["shape"], r["mesh"]): r
           for r in load_records([opt_pat]) if r.get("ok")}
    print("| arch | shape | mesh | step_ms base→opt | dominant base→opt | "
          "fraction base→opt | speedup |")
    print("|---|---|---|---|---|---|---|")
    gains = []
    for k in sorted(base):
        if k not in opt:
            continue
        b, o = base[k], opt[k]
        sp = b["step_time_s"] / max(o["step_time_s"], 1e-12)
        gains.append(sp)
        print(f"| {k[0]} | {k[1]} | {k[2]} | "
              f"{b['step_time_s']*1e3:.0f}→{o['step_time_s']*1e3:.0f} | "
              f"{b['dominant']}→{o['dominant']} | "
              f"{b['roofline_fraction']:.3f}→{o['roofline_fraction']:.3f} | "
              f"{sp:.2f}x |")
    if gains:
        gm = math.exp(sum(math.log(g) for g in gains) / len(gains))
        print(f"\ngeometric-mean roofline step-time speedup over "
              f"{len(gains)} cells: {gm:.2f}x")


if __name__ == "__main__":
    main()
