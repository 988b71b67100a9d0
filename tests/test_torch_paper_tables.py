"""The port's paper experiments (``repro_torch.benchmarks.paper_tables``)
on the CPU: ``_eval_common`` against the JAX package's on the same ids;
``run_setting``'s Table 1 rows against JAX's ``run_setting`` on the same
trained WOL and queries, with the same random picks; and
``run_setting``, ``table2_kl_sweep`` and ``fig2_collision_curves`` end
to end on tiny settings put in place of the paper's.

Tolerances: ``_eval_common``'s P@1, P@5 and recall within 1e-6 of JAX's
(both are fp32 means of the same hit counts), its sample and MFLOP
exact.  ``run_setting``'s rows: every column but the time within 1e-6
(P@1, P@5, recall: fp32 means of equal hit counts; sample and MFLOP:
the same sums in another order), methods and datasets equal.  The
end-to-end runs return the reference's row types and keys, with finite
metrics in range.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import baselines as JB  # noqa: E402
from benchmarks import paper_tables as jpt  # noqa: E402
from repro.configs.paper_datasets import \
    PaperSetting as JPaperSetting  # noqa: E402
from repro.core.lss import LSSConfig as JLSSConfig  # noqa: E402
from repro_torch.benchmarks import baselines as B  # noqa: E402
from repro_torch.benchmarks import paper_tables as pt  # noqa: E402
from repro_torch.configs.paper_datasets import PaperSetting  # noqa: E402
from repro_torch.convert import lss_index_from_numpy  # noqa: E402
from repro_torch.core.lss import LSSConfig  # noqa: E402
from repro_torch.models.lstm import LSTMConfig  # noqa: E402
from repro_torch.models.xc import XCConfig  # noqa: E402

# m = 2,000 labels: K = 4 gives P = 256, so L = 10 has C = 2,560 > 2,048
N_TRAIN = 600                  # 150 test rows, 450 training rows
TINY_XC = PaperSetting(
    name="tiny-xc", kind="xc",
    full=XCConfig("tiny-xc", input_dim=400, hidden=16, output_dim=2000),
    bench=XCConfig("tiny-xc-bench", input_dim=400, hidden=16,
                   output_dim=2000, max_in=8, max_labels=4),
    lss=LSSConfig(k_bits=4, n_tables=1),
    bench_lss=LSSConfig(k_bits=4, n_tables=1, iul_epochs=2,
                        iul_inner_steps=2, iul_lr=0.02))
TINY_LSTM = PaperSetting(
    name="tiny-lstm", kind="lstm",
    full=LSTMConfig("tiny-lstm", vocab=300, hidden=16),
    bench=LSTMConfig("tiny-lstm-bench", vocab=300, hidden=16),
    lss=LSSConfig(k_bits=4, n_tables=1),
    bench_lss=LSSConfig(k_bits=4, n_tables=1, iul_epochs=2,
                        iul_inner_steps=2, iul_lr=0.02))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small CPU ops: one intra-op thread, as in the trainer tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """The tiny settings in place of the paper's, at the fast sizes, with
    the XC model trained on N_TRAIN rows for at most 20 steps."""
    monkeypatch.setattr(pt, "SETTINGS", {s.name: s
                                         for s in (TINY_XC, TINY_LSTM)})
    monkeypatch.setattr(pt, "FAST", True)
    train_xc = pt._train_xc

    def small(setting, n_train, steps, device):
        return train_xc(setting, n_train=N_TRAIN, steps=min(steps, 20),
                        device=device)

    monkeypatch.setattr(pt, "_train_xc", small)


def test_eval_common_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 40, size=(64, 5)).astype(np.int32)
    lab = rng.integers(-1, 40, size=(64, 4)).astype(np.int32)
    lab[:, 0] = np.abs(lab[:, 0])                   # a label in every row
    q = rng.normal(size=(64, 9)).astype(np.float32)
    want = jpt._eval_common("x", lambda: (jnp.asarray(ids), 123),
                            jnp.asarray(q), jnp.asarray(lab), 9)
    got = pt._eval_common("x", lambda: (torch.from_numpy(ids), 123),
                          torch.from_numpy(q), torch.from_numpy(lab), 9)
    for g, w, name in zip(got[:3], want[:3], ("P@1", "P@5", "recall")):
        assert g == pytest.approx(w, abs=1e-6), name
    assert got[3] == want[3] == 123
    assert got[5] == want[5]
    assert got[4] > 0                                   # microseconds


def _jax_pq_starts(key, m, n_subspaces=8, n_codes=256):
    """The rows JAX's ``pq_build`` starts each subspace's k-means from."""
    keys = jax.random.split(key, n_subspaces)
    return np.stack([np.asarray(jax.random.choice(
        k, m, (n_codes,), replace=m < n_codes)) for k in keys])


@pytest.mark.parametrize("kind", ["xc", "lstm"])
def test_run_setting_rows_match_jax(kind, monkeypatch):
    """Both packages' ``run_setting`` on one trained WOL and one set of
    queries (their ``_train_*`` patched to return the same numpy arrays).
    JAX's keys make the random picks; the port takes them: LSS gets JAX's
    fitted index, SLIDE JAX's hyperplanes, PQ JAX's k-means starting rows
    and ip-NSW JAX's entry points, through the port's deterministic
    builders.  So every row is assembled from the same indexes, and the
    rows must agree column by column (time aside)."""
    m, d, n_tr, n_te = 2000, 16, 450, 150
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    q = rng.normal(size=(n_tr + n_te, d)).astype(np.float32)
    noisy = q @ w.T + b + rng.normal(size=(n_tr + n_te, m)) * 0.5
    lab = np.argsort(-noisy, 1)[:, :1 if kind == "lstm" else 4]
    lab = lab.astype(np.int32)
    if kind == "xc":
        lab[::3, 3] = -1                               # padded label rows
    parts = (q[n_te:], lab[n_te:], q[:n_te], lab[:n_te])
    cfg = (TINY_LSTM.bench._replace(vocab=m) if kind == "lstm"
           else TINY_XC.bench)
    jlss = JLSSConfig(**TINY_XC.bench_lss._asdict())
    name = f"tiny-{kind}"
    train_fn = "_train_lstm" if kind == "lstm" else "_train_xc"

    # the reference, recording what its keys pick
    picked = {}
    monkeypatch.setattr(jpt, "SETTINGS", {name: JPaperSetting(
        name, kind, cfg, cfg, jlss, jlss)})
    monkeypatch.setattr(jpt, "FAST", True)
    monkeypatch.setattr(jpt, train_fn, lambda *a, **k: (
        {"w_out": jnp.asarray(w), "b_out": jnp.asarray(b)}, cfg,
        *map(jnp.asarray, parts)))

    def record(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(key, *args, **kwargs):
            picked[fn_name] = (key, fn(key, *args, **kwargs))
            return picked[fn_name][1]
        monkeypatch.setattr(mod, fn_name, wrapper)

    record(jpt, "fit_lss")
    for fn_name in ("slide_build", "pq_build", "ipnsw_build"):
        record(JB, fn_name)
    want = jpt.run_setting(name)

    # the port, given the same picks
    setting = TINY_LSTM if kind == "lstm" else TINY_XC
    monkeypatch.setattr(pt, "SETTINGS", {name: setting._replace(name=name)})
    monkeypatch.setattr(pt, "FAST", True)
    monkeypatch.setattr(pt, train_fn, lambda *a, **k: (
        {"w_out": torch.from_numpy(w), "b_out": torch.from_numpy(b)}, cfg,
        *map(torch.from_numpy, parts)))
    jindex, jhist = picked["fit_lss"][1]
    index = lss_index_from_numpy(
        theta=np.array(jindex.theta),
        table_ids=np.array(jindex.tables.table_ids),
        n_dropped=np.array(jindex.tables.n_dropped),
        w_bucketed=np.array(jindex.w_bucketed), w_scale=None,
        k_bits=jindex.tables.k_bits, n_tables=jindex.tables.n_tables,
        capacity=jindex.tables.capacity, device="cpu")
    monkeypatch.setattr(pt, "fit_lss", lambda *a: (index, jhist))
    theta = torch.from_numpy(np.array(picked["slide_build"][1].theta))
    monkeypatch.setattr(B, "slide_build", lambda g, w_, b_, c:
                        B.slide_index(w_, b_, theta, c))
    starts = torch.from_numpy(_jax_pq_starts(picked["pq_build"][0], m))
    monkeypatch.setattr(B, "pq_build", lambda g, w_, b_, n_subspaces,
                        n_iters: B.pq_index(w_, b_, starts, n_iters))
    entry = torch.from_numpy(np.array(picked["ipnsw_build"][1].entry))
    monkeypatch.setattr(B, "ipnsw_build", lambda g, w_, b_:
                        B.ipnsw_index(w_, b_, entry))
    seen = []
    got = pt.run_setting(name, device="cpu",
                         on_setting=lambda *a: seen.append(a))

    pq = B.pq_index(torch.from_numpy(w), torch.from_numpy(b), starts, 6)
    assert np.array_equal(pq.codes.numpy(),
                          np.asarray(picked["pq_build"][1].codes))
    assert len(seen) == 1
    rows, idx, q_te, train_s = seen[0]
    assert rows == got and idx is index and train_s >= 0
    assert torch.equal(q_te, torch.from_numpy(parts[2]))
    assert [(r.dataset, r.method) for r in got] == \
        [(r.dataset, r.method) for r in want]
    for g, r in zip(got, want):
        for col in ("p1", "p5", "recall", "sample", "mflop_per_query"):
            assert getattr(g, col) == pytest.approx(
                getattr(r, col), rel=1e-6, abs=1e-6), (r.method, col)


def test_eval_methods_takes_train_or_index():
    w, b = torch.zeros(8, 4), torch.zeros(8)
    q, lab = torch.zeros(2, 4), torch.zeros(2, 1, dtype=torch.int32)
    for kw in ({}, {"train": (q, lab), "index": object()}):
        with pytest.raises(ValueError, match="exactly one"):
            pt.eval_methods("x", TINY_XC.bench_lss, w, b, q, lab, **kw)


def _check_rows(rows, name, m):
    assert [r.method for r in rows] == ["Full", "LSS", "SLIDE", "PQ",
                                        "ip-NSW"]
    assert pt.Row._fields == jpt.Row._fields
    for r in rows:
        assert isinstance(r, pt.Row) and r.dataset == name
        vals = [r.p1, r.p5, r.recall, r.sample, r.us_per_query,
                r.mflop_per_query]
        assert all(isinstance(v, float) or isinstance(v, int) for v in vals)
        assert all(math.isfinite(v) for v in vals)
        assert 0 <= r.p1 <= 1 and 0 <= r.p5 <= 1 and 0 <= r.recall <= 1
        assert r.us_per_query > 0 and r.mflop_per_query > 0
    assert rows[0].sample == rows[3].sample == m        # Full, PQ
    assert rows[0].recall == 1.0
    assert 0 < rows[1].sample < m and 0 < rows[2].sample < m


def test_run_setting_xc_and_lstm(tiny):
    _check_rows(pt.run_setting("tiny-xc", steps=20, device="cpu"),
                "tiny-xc", 2000)
    _check_rows(pt.run_setting("tiny-lstm", steps=4,
                                device="cpu"), "tiny-lstm", 300)


def test_table2_and_fig2(tiny):
    cells = []
    rows = pt.table2_kl_sweep("tiny-xc", device="cpu",
                              on_cell=lambda row, index, q:
                              cells.append((row, index, q.shape)))
    assert [(r["K"], r["L"]) for r in rows] == [(4, 1), (4, 10), (6, 1),
                                                (6, 10)]
    for r in rows:
        assert list(r) == ["K", "L", "P@1", "P@5", "sample"]
        assert 0 <= r["P@1"] <= 1 and 0 <= r["P@5"] <= 1
        assert 0 < r["sample"] <= 2000
    big = [c for c in cells
           if c[1].tables.n_tables * c[1].tables.capacity > 2048]
    assert big and big[0][0] is rows[1]
    assert all(c[2] == (N_TRAIN // 4, 16) for c in cells)  # the test rows
    hist = pt.fig2_collision_curves("tiny-xc", device="cpu")
    assert set(hist) == {"loss", "p_collide_pos", "p_collide_neg",
                         "recall"}
    assert all(len(v) == TINY_XC.bench_lss.iul_epochs for v in hist.values())
