"""The port's kernel registry, device resolution and import boundary."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def op():
    """A throwaway op with both impls; restores the registry afterwards."""
    o = registry.kernel_op("test_torch_registry_op")
    o.register_impl("ref", lambda x: ("ref", x))
    o.register_impl("cuda", lambda x: ("cuda", x))
    registry.reset_dispatch_log()
    yield o
    registry._ops.pop(o.name, None)
    registry.reset_dispatch_log()


def test_auto_resolves_by_device(op):
    assert registry.resolve_impl(op.name, None, "cpu") == "ref"
    assert registry.resolve_impl(op.name, None, "cuda") == "cuda"
    assert op(torch.zeros(1))[0] == "ref"
    assert registry.last_dispatch(op.name) == "ref"


def test_resolution_order(op, monkeypatch):
    # the device decides; an explicit impl= must agree with it, and no
    # process or environment setting overrides it
    monkeypatch.setenv("REPRO_TORCH_KERNEL_IMPL", "cuda")
    assert registry.resolve_impl(op.name, None, "cpu") == "ref"
    assert registry.resolve_impl(op.name, "ref", "cpu") == "ref"
    assert registry.resolve_impl(op.name, "cuda", "cuda") == "cuda"
    assert registry.resolve_impl(op.name, None, torch.device("cuda", 1)) \
        == "cuda"
    with pytest.raises(RuntimeError, match="no fallback"):
        registry.resolve_impl(op.name, "ref", "cuda")
    assert op(torch.zeros(1), impl="ref")[0] == "ref"


def test_unknown_and_missing_impls(op):
    with pytest.raises(ValueError):
        registry.resolve_impl(op.name, "pallas")
    with pytest.raises(ValueError):
        op.register_impl("triton", lambda x: x)
    ref_only = registry.kernel_op("test_torch_registry_ref_only")
    ref_only.register_impl("ref", lambda x: x)
    try:
        with pytest.raises(KeyError):
            registry.resolve_impl(ref_only.name, None, "cuda")
        assert registry.resolve_impl(ref_only.name, None, "cpu") == "ref"
    finally:
        registry._ops.pop(ref_only.name)
    with pytest.raises(KeyError):
        registry.get_op("no_such_op")


def test_no_fallback_between_devices(op):
    with pytest.raises(RuntimeError, match="no fallback"):
        op(torch.zeros(1), impl="cuda")
    assert registry.dispatch_counts() == {}     # refused calls never log


def test_strategies_resolve_in_order(monkeypatch):
    strat = registry.kernel_strategy(
        "test_torch_registry.knob", ("a", "b"), env_var="TEST_TORCH_KNOB",
        auto=lambda n=0, **_: "b" if n > 10 else "a")
    try:
        monkeypatch.delenv("TEST_TORCH_KNOB", raising=False)
        assert strat.resolve(n=3) == "a" and strat.resolve(n=30) == "b"
        monkeypatch.setenv("TEST_TORCH_KNOB", "b")
        assert strat.resolve(n=3) == "b"
        with registry.use_strategy(strat.name, "a"):
            assert strat.resolve(n=30) == "a"
            assert strat.resolve("b", n=3) == "b"
        with pytest.raises(ValueError):
            strat.resolve("c")
        assert registry.get_strategy(strat.name) is strat
    finally:
        registry._strategies.pop(strat.name)


def test_port_strategies_registered():
    names = registry.list_strategies()
    assert "lss_topk.dedup" in names and "lss_topk.slab_dtype" in names
    ops = ("simhash_codes", "lss_topk", "bucket_logits")
    assert set(ops) <= set(registry.list_ops())
    for name in ops:
        assert set(registry.get_op(name).impls) == {"ref", "cuda"}


def test_dispatch_log_is_bounded(op):
    n = registry.LOG_MAXLEN + 10
    for _ in range(n):
        op(torch.zeros(1))
    assert len(registry.dispatch_log()) == registry.LOG_MAXLEN
    assert registry.dispatch_counts()[(op.name, "ref")] == n
    registry.reset_dispatch_log()
    assert registry.dispatch_log() == () and registry.dispatch_counts() == {}


def test_device_none_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_import_without_jax_or_reference_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                               'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'repro_torch.benchmarks.paper_tables' in names\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# the JAX package, its top-level benchmarks package, or JAX itself
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro|benchmarks)(?:\.|\s|$)",
    re.MULTILINE)


def test_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert ROOT / "src/repro_torch/benchmarks/baselines.py" in files
    for f in files:
        hits = IMPORT_RE.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_package_imports_lazily():
    # importing builds nothing: the kernels build inside the first launch
    from repro_torch.kernels import _build
    assert _build._libs == {}
    assert repro_torch.resolve_device is resolve_device
