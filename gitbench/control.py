"""The readings that set a cell's `score_gap_bf16` and `search_gap_nats`
limits, on the chip:

    python3 gitbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed, one process runs the cell as run.py does (set-up, a window of
`--seconds` at the cell's own load, the judge) and reads `score_gap_bf16` twice
over the same sampled outputs: the program's against the plain reference
(the lower reading), and the control's, the reference one step below the
configuration's precision put in the program's place (fp8 e4m3 for every
bf16 operand, int4 for the int8 weights; reference.py, precision 'lowp'),
against the reference (the upper reading); and likewise `search_gap_nats`
where the cell compares it, the control's own search choosing in the
program's place.  `control_correct`
is the verdict the judge gives the control (`judge.control_passed`), which
has to be false.  One JSON line a seed, then a summary: each number's
largest program reading and smallest control reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gitbench import harness, judge, spec

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)
    program, control = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = harness.run(bench, cell, seed, args.seconds, 0, "cuda", time.perf_counter(),
                        lambda m: print(m, file=sys.stderr, flush=True), control=True)
        c = r["checks"]
        line = dict(seed=seed, correct=r["correct"], control_correct=judge.control_passed(c),
                    unmatched=c["unmatched"]["value"], missing=c["missing"]["value"])
        for name in [k for k in c if "control_" + k in c]:
            line[name] = c[name]["value"]
            line["control_" + name] = c["control_" + name]["value"]
            program.setdefault(name, []).append(line[name])
            control.setdefault(name, []).append(line["control_" + name])
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(workload=cell["name"], card=harness.card_line(),
                          program_max={k: max((x for x in v if x is not None), default=None)
                                       for k, v in program.items()},
                          control_min={k: min((x for x in v if x is not None), default=None)
                                       for k, v in control.items()},
                          program=program, control=control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
