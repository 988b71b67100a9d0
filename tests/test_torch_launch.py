"""The port's launchers and arch registry on the CPU (counterpart of the
JAX package's ``repro.launch.{serve,train}`` and ``repro.configs.
{base,registry}``): each of the ten ``ArchSpec``s equals JAX's field for
field (dtypes mapped), ``launch.serve`` runs every mode at the reduced
size (generate with both heads, streaming decode and async scoring with
online index refresh; streaming decode of the reduced MoE LM too), both
launchers refuse a non-LM arch by its family, ``--mode decode`` on a
fleet exits
before any work (the fleets themselves run in test_torch_multihost.py),
``launch.train``'s multi-GPU flags exit before any work where they
describe no fleet (its sharded runs are in test_torch_sharded_train.py),
and ``launch.train`` trains and then resumes."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.base import lm_shapes as j_lm_shapes  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ArchSpec, lm_shapes  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.kernels import registry as kregistry  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
SMALL = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
         "--train-steps", "4", "--steps", "4", "--batch", "4"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the launchers train: one intra-op thread, as the trainer tests pin
    # it (eight OpenMP threads a worker under pytest -n 6 crawl)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(cfg):
    d = cfg._asdict()
    d["dtype"] = DTYPES.get(d["dtype"], d["dtype"])
    return d


def _port_dict(cfg):
    """A port config's fields less those the port alone has, each at the
    default that computes what the JAX package computes."""
    d = cfg._asdict()
    if "norm_topk_prob" in d:
        assert d.pop("norm_topk_prob") is True
    return d


# ------------------------------------------------------------ configs --

@pytest.mark.parametrize("arch", registry.ALL_ARCHS)
def test_arch_spec_mirrors_jax(arch):
    j, t = jregistry.get_config(arch), registry.get_config(arch)
    assert isinstance(t, ArchSpec)
    assert t._fields == j._fields
    assert (t.arch_id, t.family, t.notes) == (j.arch_id, j.family, j.notes)
    assert _cfg_dict(j.model_cfg) == _port_dict(t.model_cfg)
    assert t.model_cfg.dtype == (torch.bfloat16 if t.family == "lm"
                                 else torch.float32)
    assert t.model_cfg.param_count() == j.model_cfg.param_count()
    assert (t.lss is None) == (j.lss is None)
    if t.lss is not None:
        assert t.lss._asdict() == j.lss._asdict()
    assert t.shapes == j.shapes and list(t.shapes) == list(j.shapes)
    name = list(j.shapes)[-1]
    assert t.shape(name) == j.shape(name)
    assert _cfg_dict(jreduced.reduced_model_cfg(arch)) == \
        _port_dict(reduced_model_cfg(arch))


def test_lm_shapes_mirror_jax():
    assert lm_shapes() == j_lm_shapes()
    assert registry.ALL_ARCHS == [
        "arctic-480b", "qwen2-moe-a2.7b", "qwen2-0.5b", "qwen2-7b",
        "qwen3-4b", "gcn-cora", "bert4rec", "dien", "deepfm", "autoint"]


def test_registry_covers_the_jax_ids():
    assert registry.ALL_ARCHS == jregistry.ALL_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-2")


# ------------------------------------------------------ serve launcher --

@pytest.mark.parametrize("head", ["full", "lss"])
def test_serve_generate_both_heads(head, capsys):
    kregistry.reset_dispatch_log()
    out = serve.main(SMALL + ["--head", head, "--slab-dtype", "bf16",
                              "--dedup", "bitonic"])
    assert out["mode"] == "generate" and out["refresh"] is None
    toks = out["tokens"]
    assert toks.shape == (4, 4) and ((toks >= 0) & (toks < 512)).all()
    builds = {k for k, n in out["compile_counts"].items() if n == 1}
    assert {k for k in builds if k[0] == head} == builds
    log = kregistry.dispatch_log()
    if head == "lss":
        assert ("lss_topk.slab_dtype", "bf16") in log
        assert ("lss_topk.dedup", "bitonic") in log
    assert kregistry.get_strategy("lss_topk.dedup").resolve(
        n_candidates=4) == "quadratic"          # the pin was scoped
    assert f"decoded (4, 4) tokens; head={head}" in capsys.readouterr().out


def test_serve_decode_with_refresh(capsys):
    out = serve.main(SMALL + ["--mode", "decode", "--streams", "2",
                              "--sessions", "4", "--qps", "0",
                              "--refresh-interval", "0.05"])
    assert out["served"] == out["sessions"] == 4
    s = out["stats"]
    assert s["n_decode_done"] == 4 and s["n_decode_tokens"] == 16
    r = out["refresh"]
    assert r["failures"] == 0 and r["swaps"] >= 1 and r["rollbacks"] == 0
    assert r["epoch"] >= 2
    text = capsys.readouterr().out
    assert "4/4 sessions served" in text
    assert f"index refresh: swaps={r['swaps']} rollbacks=0 failures=0 " \
           f"epoch={r['epoch']}" in text


def test_serve_moe_decode(capsys):
    """The reduced qwen2-moe-a2.7b (shared + routed experts) trains, fits
    its LSS head and streams decode sessions through the launcher."""
    out = serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                      "cpu", "--train-steps", "4", "--batch", "4",
                      "--mode", "decode", "--streams", "2", "--sessions",
                      "4", "--steps", "4", "--qps", "0"])
    assert out["served"] == out["sessions"] == 4
    assert out["stats"]["n_decode_tokens"] == 16
    assert "4/4 sessions served" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["bert4rec", "gcn-cora", "deepfm"])
def test_launchers_refuse_non_lm_archs_by_family(arch, capsys):
    family = registry.get_config(arch).family
    with pytest.raises(SystemExit, match=f"{arch} is a {family} model"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert exc.value.code == 2
    assert f"{arch} is a {family} model" in capsys.readouterr().out


def test_serve_async_with_audit_metrics_and_refresh(capsys):
    out = serve.main(SMALL + ["--runtime", "async", "--qps", "0",
                              "--audit-rate", "1.0", "--metrics-port", "0",
                              "--refresh-interval", "0.05"])
    assert out["mode"] == "async" and out["served"] == out["requests"] == 16
    assert out["audit"]["rows"] > 0 and out["audit"]["rate"] == 1.0
    assert out["stats"]["n_shed_queue"] == 0
    r = out["refresh"]
    assert r["failures"] == 0 and r["swaps"] >= 1
    text = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in text
    assert "16/16 served" in text


FLEET = ["--coordinator", "127.0.0.1:1234", "--num-processes", "2"]


@pytest.mark.parametrize("flags", [FLEET + ["--head", "lss-sharded"],
                                   FLEET,
                                   FLEET + ["--process-id", "1"],
                                   ["--process-id", "1"]])
def test_serve_multi_gpu_flags_exit_before_any_work(flags, monkeypatch):
    # streaming decode on a fleet is refused before the process group
    # starts (the flags, or the REPRO_DIST_COORDINATOR-family variables for the last case)
    def no_work(*a, **k):
        raise AssertionError("the launcher started work")

    if "--coordinator" not in flags:
        monkeypatch.setenv("REPRO_DIST_COORDINATOR", "127.0.0.1:1234")
        monkeypatch.setenv("REPRO_DIST_NUM_PROCESSES", "2")
    monkeypatch.setattr(serve, "lm_dataset", no_work)
    monkeypatch.setattr(serve, "resolve_device", no_work)
    monkeypatch.setattr(serve, "init_multihost", no_work)
    with pytest.raises(SystemExit) as exc:
        serve.main(SMALL + ["--mode", "decode"] + flags)
    assert exc.value.code not in (0, None)
    assert "--mode decode is not supported with multi-process" in \
        str(exc.value.code)


def test_serve_impl_must_fit_the_device(monkeypatch):
    monkeypatch.setattr(serve, "lm_dataset", None)   # never reached
    with pytest.raises(RuntimeError, match="no fallback"):
        serve.main(SMALL + ["--impl", "cuda"])


# ------------------------------------------------------ train launcher --

def test_train_runs_then_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = train.main(argv)
    assert first["step"] == 3 and not first["resumed"]
    assert np.isfinite(first["loss"])
    assert "done: step 3 loss" in capsys.readouterr().out
    again = train.main(argv)
    assert again == {"step": 3, "resumed": True, "history": [],
                     "loss": None}
    text = capsys.readouterr().out
    assert "[trainer] resumed from step 3" in text
    assert "resumed at step 3: nothing left to train" in text


@pytest.mark.parametrize("flags", [["--devices", "8"], ["--mesh", "2x4"]])
def test_train_multi_gpu_flags_exit(flags, monkeypatch):
    # --devices without a mesh of as many ranks, and --mesh without its
    # ranks (no --devices and no fleet variables), stop before any work
    monkeypatch.setattr(train, "lm_dataset", None)   # never reached
    for var in ("REPRO_DIST_COORDINATOR", "REPRO_DIST_NUM_PROCESSES",
                "REPRO_DIST_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu"]
                   + flags)
    want = "--mesh DxM with D*M = 8" if flags[0] == "--devices" else \
        "--mesh 2x4 needs its ranks"
    assert want in str(exc.value.code)
