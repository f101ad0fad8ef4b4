"""Readings that the output check's limits are set from, in one process on
the card: the program's run on each of ``--seeds`` and the control's (the
reference one precision below the configuration's, in the program's place)
on each of ``--control-seeds``, at the cell's own size. Not run by the
benchmark's own runs.

    python -m bench_port.calibrate --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9 --out FILE

Each reading is a JSON line in ``--out``; the last lines on standard output
give, for each number, the largest program reading and the smallest
control reading."""

from __future__ import annotations

import argparse
import gc
import json
import sys

from bench_port import manifest, run


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python -m bench_port.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    readings = {"port": {}, "control": {}}
    with open(args.out, "a") as f:
        for program, seeds in (("port", args.seeds), ("control", args.control_seeds)):
            for seed in seeds:
                result, lines = run.run_cell(cell, seed, 0.0, False, "cuda", program=program)
                values = {k: v["value"] for k, v in result["check"].items()}
                readings[program][seed] = values
                f.write(json.dumps(dict(workload=args.workload, program=program, seed=seed, values=values,
                                        correct=result["correct"], metrics=result["metrics"])) + "\n")
                f.flush()
                print(program, seed, json.dumps(values), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
    for name in cell.limits:
        lo = [v[name] for v in readings["port"].values() if v.get(name) is not None]
        hi = [v[name] for v in readings["control"].values() if v.get(name) is not None]
        print(f"{name}: program max {max(lo) if lo else None!r} over {len(lo)}, "
              f"control min {min(hi) if hi else None!r} over {len(hi)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
