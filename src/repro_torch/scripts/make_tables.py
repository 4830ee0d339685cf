"""Render the dry-run's tables from ``experiments/dryrun_torch/*.json``.

Port of ``scripts/make_tables.py``: the same three tables (the dry-run
matrix, the single-pod roofline, the collective wire bytes) from the
artifacts ``launch.dryrun`` writes, in the reference's layout.  The port's
artifacts carry the trace's seconds (``trace_s``) where the reference's
carry the proof compile's (``proof_compile_s``); the matrix's last column
is headed by whichever the artifacts hold.

Usage:
  PYTHONPATH=src python -m repro_torch.scripts.make_tables \\
      [DIR] [all|dryrun|roofline|collectives]
"""

import glob
import json
import os
import sys

DEFAULT_DIR = "experiments/dryrun_torch"


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def load(directory, mesh):
    out = {}
    for p in sorted(glob.glob(os.path.join(directory, f"*__{mesh}.json"))):
        with open(p) as f:
            c = json.load(f)
        out[(c["arch"], c["shape"])] = c
    return out


def _seconds_key(cells):
    """``trace_s`` if any artifact has it (the port's), else the
    reference's ``proof_compile_s``."""
    return "trace_s" if any("trace_s" in c for c in cells) \
        else "proof_compile_s"


def dryrun_table(directory):
    single = load(directory, "single")
    multi = load(directory, "multi")
    key = _seconds_key([*single.values(), *multi.values()])
    what = "trace" if key == "trace_s" else "proof compile"
    print("| arch | shape | 16x16: status / GiB-per-chip / fits | "
          f"2x16x16: status / GiB / fits | {what} (s) |")
    print("|---|---|---|---|---|")
    for (a, s), c in single.items():
        m = multi.get((a, s), {})

        def cell(c):
            if not c:
                return "—"
            if c["status"] == "SKIP":
                return "SKIP"
            if c["status"] != "OK":
                return "FAIL"
            return (f"OK / {fmt_bytes(c['device_hbm_bytes'])} / "
                    f"{'Y' if c['fits_hbm'] else 'N'}")
        pc = c.get(key, "—")
        mc = m.get(key, "—")
        print(f"| {a} | {s} | {cell(c)} | {cell(m)} | {pc} / {mc} |")


def roofline_table(directory):
    single = load(directory, "single")
    print("| arch | shape | Tc (s) | Tm (s) | Tx (s) | bound | frac | "
          "useful | MODEL_FLOPS | HLO_FLOPS(tot) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for (a, s), c in single.items():
        if c["status"] == "SKIP":
            print(f"| {a} | {s} | — | — | — | SKIP: {c['reason'][:40]} "
                  f"| | | | |")
            continue
        if "roofline" not in c:
            print(f"| {a} | {s} | — | — | — | {c['status']} | | | | |")
            continue
        r = c["roofline"]
        print(f"| {a} | {s} | {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f}"
              f" | {r['t_collective_s']:.4f} | {r['bottleneck']} "
              f"| {r['roofline_fraction']:.3f} | {r['useful_flops_ratio']:.2f}"
              f" | {c['model_flops']:.2e} "
              f"| {c['flops_per_device']*c['chips']:.2e} |")


def collectives_table(directory):
    single = load(directory, "single")
    print("| arch | shape | all-reduce GiB | all-gather GiB | "
          "reduce-scatter GiB | a2a GiB | permute GiB |")
    print("|---|---|---|---|---|---|---|")
    for (a, s), c in single.items():
        if c.get("status") != "OK" or "collectives" not in c:
            continue
        k = c["collectives"]
        g = lambda n: f"{k.get(n, 0)/2**30:.2f}"      # noqa: E731
        print(f"| {a} | {s} | {g('all-reduce')} | {g('all-gather')} | "
              f"{g('reduce-scatter')} | {g('all-to-all')} | "
              f"{g('collective-permute')} |")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else DEFAULT_DIR
    which = argv[1] if len(argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("### Dry-run matrix\n")
        dryrun_table(directory)
        print()
    if which in ("all", "roofline"):
        print("### Roofline (single-pod 16x16, per-cell)\n")
        roofline_table(directory)
        print()
    if which in ("all", "collectives"):
        print("### Collective wire bytes per device (single-pod)\n")
        collectives_table(directory)


if __name__ == "__main__":
    main()
