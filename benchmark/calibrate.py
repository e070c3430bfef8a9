"""The readings that the limits of ``correct`` are set from, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--seconds 3] [--controls 3] [--controls-only] [--compute-dtype float32]

For each seed, one run of the cell with a short window at its own load:
the numbers that sound runs of the program give (the lower readings). For
the first ``--controls`` seeds, the path's ``control``: the reference in
float8 in the program's place and the faults the cell can have, at the
cell's own size (the upper readings), each judged by the harness's own
``correct`` as a run that gave those numbers would be. With
``--compute-dtype`` the program runs in that dtype, TF32 off, in place of
the configuration's: a witness of what the configuration's precision
costs. One JSON line a seed. Runs on the card only; the benchmark's own
runs never run this.
"""
import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference.semabs3d import tf32_off  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--controls-only", action="store_true",
                    help="read the controls of the first --controls seeds, not the program")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    help="run the program in this dtype (a witness), not the configuration's")
    opts = ap.parse_args(argv)
    manifest = harness.Manifest()
    harness.card_or_exit(int(manifest.cell(opts.workload)["chips"]))
    for k, seed in enumerate(opts.seeds):
        out = {"seed": seed}
        if not opts.controls_only:
            run = harness.Run(manifest, opts.workload, seed, opts.seconds, False)
            if opts.compute_dtype:
                tf32_off()
                run.config["compute_dtype"] = opts.compute_dtype
                out["compute_dtype"] = opts.compute_dtype
            line = harness.execute(run)
            out.update(correct=line["correct"], program=line["checks"], metrics=line["metrics"],
                       facts={n: v for n, v in run.facts.items()
                              if "gap" in n or n.endswith("_s")})
        if k < opts.controls:
            run = harness.Run(manifest, opts.workload, seed, opts.seconds, False)
            driver = harness.load_module(
                os.path.join(manifest.dir, "paths", run.traffic["path"] + ".py"),
                "path_" + run.traffic["path"])
            out["controls"] = {
                name: dict(numbers, correct=harness.Run(
                    manifest, opts.workload, seed, opts.seconds, False).judge(numbers))
                for name, numbers in driver.control(run).items()}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
