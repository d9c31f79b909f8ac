"""Readings for the limits of a cell's check: the program's numbers and the
control's on each of several seeds, in one process.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 5 \\
        [--trace 1] [--resize envs=65536] [--out readings.jsonl] [--dump DIR]

The control is the plain reference put in the program's place with every
float of the state it steps from and of its result held in bfloat16 (the
precision below the float32 the configurations state). Each seed prints
one JSON line: the run's result line with the control's numbers beside
the program's. `--resize` replaces keys of the traffic mix (the E sweep).
Needs the card."""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run

run.prepare_process()  # before torch is imported

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--resize", action="append", default=[], help="traffic key=int")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--dump", default=None,
                    help="a directory for the envs of a kept step that differ from the reference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    resize = {k: int(v) for k, v in (kv.split("=") for kv in args.resize)}
    manifest = run.load_manifest()
    log = lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True)
    shared = {"dump": args.dump} if args.dump else {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run.run_cell(manifest, args.workload, seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t0, log=log, resize=resize,
                           with_control=not args.no_control, shared=shared)
        line = json.dumps({"workload": args.workload, "seed": seed, "resize": resize,
                           "seconds_total": time.perf_counter() - t0, **out})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
