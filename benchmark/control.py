"""The readings that a cell's limits are set from, in one process on the
card: the numbers compared by runs of the program on many seeds (short
windows, the cell's own sizes and load), and the same numbers for the
control, the float64 reference's computation done in TF32 in the
program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --seconds 2

Prints one JSON line per run and a summary: for each number, the largest
reading of the program (the lower reading) and the smallest of the
control (the upper one); ``--out`` also writes the lines to a file.
"""

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if pathlib.Path(p or ".").resolve()
                                 != ROOT / "benchmark"]
    import torch
    from benchmark import run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in seeds:
        result, checks = run.run_cell(args.workload, seed, args.seconds,
                                      False, args.device)
        emit({"side": "program", "seed": seed, "correct": result["correct"],
              "attempted": result["attempted"],
              "checks": {k: v for k, (v, _) in checks.items()},
              "metrics": {k: m["value"]
                          for k, m in result["metrics"].items()}})
        del result, checks
        gc.collect()
        torch.cuda.empty_cache()
    for seed in control_seeds:
        cell, traffic = run.build_cell(args.workload, seed, args.device)
        cell.release()
        readings = {}
        for p, entries in cell.control(traffic["kept"]):
            for key, value in cell.judge(p, entries).items():
                readings[key] = max(readings.get(key, 0.0), value)
        emit({"side": "control", "seed": seed, "checks": readings})
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": {}, "upper": {}}
    for line in lines:
        side = "lower" if line["side"] == "program" else "upper"
        pick = max if side == "lower" else min
        for key, value in line["checks"].items():
            old = summary[side].get(key)
            summary[side][key] = value if old is None else pick(old, value)
    emit({"summary": summary})
    if args.out:
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
