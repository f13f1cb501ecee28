"""The control of a cell's comparison: the plain reference put in the
program's place, reading its energies in bfloat16, the precision below
the float32 the configurations state.  It has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...] [--answers A]

For each seed: the sequences a run of the cell would answer first (A of
them, about what a run answers in its window), the sample of them the run
would compare, folded by the reference at float32 (what the program is
held to) and at bfloat16 (the control); one JSON line a seed with the
compared numbers beside the cell's limits.  No program and no card: it
runs on the host, in the same worker processes a run's check uses.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def control(bench, cell, seed, answers, precision="bfloat16",
            workers=None):
    """{number: value} of the control on `seed`, and the cell's limits."""
    from perfbench import check, core, traffic
    wl = bench.workload(cell)
    settings = bench.settings(bench.cell(cell)["config"])
    seqs = core.draw(wl, seed, bench.spec["run_seconds"])[:answers]
    pick = traffic.check_sample(len(seqs), wl["check_sample"],
                                check.lengths(seqs), seed)
    sample = [seqs[i] for i in pick]
    form = bench.driver(wl["driver"]).answer_form(settings)
    expected = check.reference_answers(sample, settings, form,
                                       workers=workers)
    got = check.reference_answers(sample, settings, form, precision,
                                  workers=workers)
    numbers = {"mismatched_answers": check.mismatches(got, expected),
               "refolded_calls": 0}
    return {k: numbers[k] for k in wl["limits"]}, wl["limits"], len(sample)


def main(argv=None):
    import argparse
    import json

    from perfbench import core
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=None,
                    help="answers a run makes (default: the workload's "
                         "control_answers)")
    args = ap.parse_args(argv)
    bench = core.Bench(ROOT)
    answers = args.answers or bench.workload(args.workload)["control_answers"]
    for seed in args.seeds:
        numbers, limits, n = control(bench, args.workload, seed, answers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "compared": n, "numbers": numbers,
                          "limits": limits,
                          "not_correct": any(numbers[k] > limits[k]
                                             for k in limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
