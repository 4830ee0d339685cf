"""The readings that a cell's limits are set from: the program's widest gap
on each seed, and its control's.

    python3 oocbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed the mix's operand sets are made as a run makes them; the
program answers each set once through the cell's driver (one prepared
runtime for all seeds), and the control, the plain reference computed in
the nearest precision below the configuration's (``solve(control=True)``),
answers it in the program's place.  Both are compared whole with the
reference, as a run compares what it keeps.  A line of JSON a seed, then a
summary: ``lower``, the largest program reading, and ``upper``, the
smallest control reading.  The benchmark's runs never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root, name, seeds, device="cuda", log=sys.stdout):
    import torch

    from oocbench.harness import check, traffic as tgen
    from oocbench.harness.manifest import Manifest
    from oocbench.harness.record import recording_executor

    device = torch.device(device)
    _, config, mix, driver, reference = Manifest(root).parts(name)
    scalars = dict(mix.get("scalars", {}))
    handle = driver.prepare(config, recording_executor(torch_device=device))
    rows = []
    for seed in seeds:
        row = {"seed": seed, "program": 0.0, "control": 0.0}
        for ops in tgen.make_sets(mix, config, seed, device):
            out = driver.call(handle, ops, scalars, config)
            dev_ops = {k: v.to(device) for k, v in ops.items()}
            ref = reference.solve(dev_ops, scalars, control=False)
            scale = float(ref.abs().max())
            row["program"] = max(row["program"], check.gap(out, ref, scale))
            del out
            ctl = reference.solve(dev_ops, scalars, control=True)
            row["control"] = max(row["control"], check.gap(ctl, ref, scale))
            del ctl, ref, dev_ops
        print(json.dumps(row), file=log, flush=True)
        rows.append(row)
    summary = {"workload": name, "seeds": len(rows),
               "lower": max(r["program"] for r in rows),
               "upper": min(r["control"] for r in rows)}
    print(json.dumps(summary), file=log, flush=True)
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    readings(ROOT, args.workload, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
