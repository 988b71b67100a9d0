"""The docs lint (``tools/check_docs.py``, a required CI step) passes with
the port in the tree: the README's paths to the port resolve, and every
``REPRO_*`` variable the port reads is one that ``docs/KERNELS.md``
lists."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_check_docs_passes():
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_docs.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_port_reads_the_documented_env_vars():
    from repro_torch import obs
    from repro_torch.kernels.lss_topk import dedup, slabs
    doc = (ROOT / "docs" / "KERNELS.md").read_text()
    for name in (dedup.DEDUP_ENV_VAR, dedup.AUTO_THRESHOLD_ENV_VAR,
                 slabs.SLAB_DTYPE_ENV_VAR):
        assert name.startswith("REPRO_LSS_") and f"`{name}`" in doc
    # the observability switches: the same names as the JAX package's
    assert (obs.OBS_ENV, obs.AUDIT_RATE_ENV, obs.TRACE_CAP_ENV) == (
        "REPRO_OBS", "REPRO_OBS_AUDIT_RATE", "REPRO_OBS_TRACE_CAP")
    for name in (obs.OBS_ENV, obs.AUDIT_RATE_ENV, obs.TRACE_CAP_ENV):
        assert f"`{name}`" in doc
