"""Run one cell of the benchmark once, on this machine's cards.

    python3 wolbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``wolbench/configs/``) and a traffic mix (``wolbench/traffic/``); the
configuration's ``kind`` picks the driver (``wolbench/harness/
<kind>_cell.py``).  The driver makes its weights and traffic from
``--seed``, warms every shape the cell uses (set-up), measures for
``--seconds``, then holds what it served against the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics, each read by
``wolbench/metrics/<name>.py`` from a profiled part of the window and the
program's spans), ``device`` and, traced, ``breakdown``; last, under
``checks``, each number compared with its limit, which also end standard
error.  No card, too few cards, or JAX or the JAX package loaded: no
result line and a nonzero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# the span ring must hold a whole traced window (read at import)
os.environ["REPRO_OBS_TRACE_CAP"] = "4000000"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def program_is_here() -> str | None:
    """None when ``repro_torch`` imports from this checkout's ``src``."""
    try:
        import repro_torch
    except ImportError as exc:
        return f"the program is missing: {exc}"
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        return f"repro_torch imports from {where}, not from this checkout"
    return None


def checks_of(cell, res) -> dict:
    """Each number compared with its limit (the configuration's)."""
    got = res["checks"]
    return {name: {"value": got[name], "limit": limit}
            for name, limit in cell.config["limits"].items() if name in got}


def verdict(res, checks) -> bool:
    return (res["compared"] > 0 and res["failed"] == 0
            and not res["failures"] and bool(checks)
            and all(c["value"] <= c["limit"] for c in checks.values()))


def result_line(cell, res, trace: bool, device, power: str) -> dict:
    from wolbench.harness import spec
    from wolbench.harness.device import device_line
    ctx = res["ctx"]
    metrics = {}
    if not trace:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            value = values.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_line(device, cell.chips, res["peak_bytes"])
    line = {"correct": None, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    window = ctx.prof.window if ctx.prof is not None else None
    if trace and window is not None:
        dev.update(busy_s=window["busy_s"], window_s=window["window_s"])
        line["breakdown"] = {"device_ops": window["device_ops"],
                             "idle_gaps": window["idle_gaps"]}
    checks = checks_of(cell, res)
    line["correct"] = verdict(res, checks)
    line.update(workload=cell.name, power=power,
                compared=res["compared"], failures=res["failures"],
                counts=res.get("window_counts", {}),
                readings=res["checks"], checks=checks)
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from wolbench.harness import guard, spec
    from wolbench.harness.device import power_limit, require_cards
    cell = spec.find_cell(args.workload)
    why = require_cards(cell.chips)
    if why is not None:
        print(f"wolbench: {why}; no result", file=sys.stderr)
        return 2
    why = program_is_here()
    if why is not None:
        print(f"wolbench: {why}; no result", file=sys.stderr)
        return 3
    import torch
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"wolbench.harness.{cell.config['kind']}_cell")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    line = result_line(cell, res, bool(args.trace), device, power_limit())
    found = guard.forbidden_modules()
    if found:
        print(f"wolbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
