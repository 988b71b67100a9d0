"""The import guard: what the harness and the reference load, in a fresh
interpreter, holds no module whose top-level name (the part before the
first dot) is ``jax``, ``jaxlib``, ``flax`` or ``repro``, compared whole,
so ``repro_torch`` passes; and the reference loads nothing of the
program."""

import json
import subprocess
import sys

import pytest

from wolbench.harness import guard, spec

CELLS = ["xc-lss-bulk", "qwen2-0.5b-lss-reason", "xc-full-bulk",
         "qwen2-0.5b-lss-chat"]


def _modules(code: str) -> list[str]:
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{str(spec.ROOT / 'src')!r}, "
            f"{str(spec.ROOT)!r}]\n" + code +
            "\nprint(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch.serve", "jaxtyping",
                                    "reproducible"]) == []
    assert guard.forbidden_modules(["repro.core.lss", "jax.numpy",
                                    "jaxlib", "flax.linen", "numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_no_jax(name):
    """The cell's driver, its readers and the reference, through a tiny
    run of the cell and its traced readers."""
    mods = _modules(
        "import wolbench.run\n"
        "from wolbench.tests.tiny import TinyCell\n"
        "from wolbench.harness import spec\n"
        f"cell = TinyCell({name!r})\n"
        "res = cell.run(seconds=0.5, trace=True, control=True)\n"
        "for m in cell.per_layer:\n"
        "    spec.reader(m['name'])(res['ctx'])\n")
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert guard.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        "import torch\n"
        "from wolbench.reference import common, heads, judge, qwen2, xc\n"
        "w = torch.randn(50, 4); th = torch.randn(5, 3)\n"
        "idx = common.build_index(w, None, th, 3, 1, 16)\n"
        "q = torch.randn(6, 4)\n"
        "lg, ids = heads.lss_topk(q, idx, w, None, 2)\n"
        "judge.judge_lss(q.double(), idx, w, None, ids)\n")
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" not in tops and "wolbench" in tops
    assert not any(m.startswith(("wolbench.harness", "wolbench.metrics"))
                   for m in mods)
    assert guard.forbidden_modules(mods) == []
