"""The readings the limits of ``correct`` are set from, on the card: for
each seed, one run of a cell (set-up, a window of ``--seconds``, the
program freed), its answers held against the reference (the lower
reading) and the control's answers for the same inputs, the reference in
the precision below the configuration's (TF32 for float32, fp8 linear
layers for bf16), held the same way (the upper reading).

    python3 wolbench/control.py --workload <name> --seeds 11,12,13 \\
        --seconds 10

One JSON line a seed: the program's readings and the harness's verdict
on them (``run.verdict``), and the control's readings put through the
same verdict in the program's place.  Then one line with each number's
largest program reading and smallest control reading.  The exit code is
1 where a control seed comes out correct, or a program seed does not.
The benchmark's own runs never run the control.
"""

import argparse
import gc
import importlib
import json
import sys
import time

try:
    from wolbench import run as bench_run
except ImportError:       # as a script: ``run`` puts the checkout on sys.path
    import run as bench_run


def control_verdict(cell, res) -> tuple[bool, dict]:
    """The harness's verdict on the control's readings, put in the
    program's place: each against its limit.  A control that gave no
    number has no checks, and comes out not correct."""
    ctrl = dict(res, checks=res["control_checks"] or {})
    checks = bench_run.checks_of(cell, ctrl)
    return bench_run.verdict(ctrl, checks), checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from wolbench.harness import spec
    from wolbench.harness.device import require_cards
    import torch
    cell = spec.find_cell(args.workload)
    why = require_cards(cell.chips) or bench_run.program_is_here()
    if why is not None:
        print(f"control: {why}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"wolbench.harness.{cell.config['kind']}_cell")
    prog: dict = {}
    ctrl: dict = {}
    bad: list[str] = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = driver.run(cell, seed, args.seconds, False, device,
                         time.perf_counter(), control=True)
        checks = bench_run.checks_of(cell, res)
        ok = bench_run.verdict(res, checks)
        ctrl_ok, ctrl_checks = control_verdict(cell, res)
        row = {"seed": seed, "correct": ok, "control_correct": ctrl_ok,
               "program": res["checks"], "control": res["control_checks"],
               "compared": res["compared"], "e2e": res["e2e"],
               "setup_s": res["setup_s"], "failures": res["failures"],
               "checks": checks, "control_checks": ctrl_checks}
        print(json.dumps(row), flush=True)
        if not ok:
            bad.append(f"seed {seed}: the program is not correct")
        if ctrl_ok:
            bad.append(f"seed {seed}: the control is correct")
        for name, value in res["checks"].items():
            prog[name] = max(prog.get(name, 0.0), value)
        for name, value in (res["control_checks"] or {}).items():
            ctrl[name] = min(ctrl.get(name, float("inf")), value)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "program_max": prog,
                      "control_min": ctrl, "faults": bad}), flush=True)
    for line in bad:
        print(f"control: {line}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
