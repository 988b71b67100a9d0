"""The exposition after ``obs.set_enabled`` flips: a superseded global
registry that a component still holds must leave the exposition, or a
reader of a ``scope=None`` metric reads the old registry's value (in a
full test run: the refresh tests' rollback counter read 0 after the
launcher and obs tests had run in the same process)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.obs.export import json_snapshot, prometheus_text  # noqa: E402
from tools.check_metrics import parse_exposition  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_superseded_global_registry_leaves_the_exposition():
    was = obs.enabled()
    try:
        obs.set_enabled(True)
        old = obs.registry()
        old.counter("order_probe_total").inc(0)    # held, as a refresher does
        obs.set_enabled(False)
        assert obs.registry() is not old
        obs.set_enabled(True)
        new = obs.registry()
        assert new is not old and new.enabled
        new.counter("order_probe_total").inc(3)
        old.counter("order_probe_total").inc(1)    # counts for its holder
        fams, errors = parse_exposition(prometheus_text())
        assert not errors, errors
        samples = fams["order_probe_total"]["samples"]
        assert len(samples) == 1 and samples[0][2] == 3.0
        scopes = [r["scope"] for r in json_snapshot()["registries"]]
        assert scopes.count(None) == 1
        assert old.counter("order_probe_total").value == 1.0
    finally:
        obs.set_enabled(was)


def test_launch_obs_refresh_sequence_in_one_process():
    """The order that failed: the launcher tests, then the obs tests, then
    the rollback test, in one process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly",
         "tests/test_torch_launch.py", "tests/test_torch_obs.py",
         "tests/test_torch_refresh.py::"
         "test_corrupt_recall_triggers_rollback_within_probation"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
