"""The port's SimHash primitives and bucket-major tables against the JAX
package, on the same numpy inputs (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import simhash as jsim  # noqa: E402
from repro.core import tables as jtab  # noqa: E402
from repro_torch.core import simhash as tsim  # noqa: E402
from repro_torch.core import tables as ttab  # noqa: E402
from repro_torch.testing.parity import (assert_close,  # noqa: E402
                                        assert_ints_equal, margin_rows)

M, D, K, L, CAP = 4000, 33, 4, 2, 300   # avg load 250 < P, some overflow
SEED = 0


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(SEED)
    w = rng.normal(size=(M, D)).astype(np.float32)
    theta = rng.normal(size=(D, K * L)).astype(np.float32)
    # the hash margin holds on every neuron, so every bit must agree
    assert margin_rows(w, theta).all()
    jt = jtab.build_tables(jnp.asarray(w), jnp.asarray(theta), K, L, CAP)
    jax_out = {
        "unit": np.asarray(jsim.unit(jnp.asarray(w))),
        "bits": np.asarray(jsim.hash_bits(jnp.asarray(w), jnp.asarray(theta))),
        "soft": np.asarray(jsim.soft_codes(jnp.asarray(w),
                                           jnp.asarray(theta))),
        "buckets": np.asarray(jsim.bucket_ids(jnp.asarray(w),
                                              jnp.asarray(theta), K, L)),
        "table_ids": np.asarray(jt.table_ids),
        "n_dropped": np.asarray(jt.n_dropped),
        "wb": np.asarray(jtab.bucketize_weights(jnp.asarray(w), jt)),
        "stats": {k: np.asarray(v)
                  for k, v in jtab.bucket_load_stats(jt).items()},
    }
    tt = ttab.build_tables(torch.from_numpy(w), torch.from_numpy(theta), K, L,
                           CAP)
    return w, theta, jax_out, tt


def test_augment_matches():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    np.testing.assert_array_equal(
        tsim.augment_neurons(torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jsim.augment_neurons(jnp.asarray(w), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tsim.augment_neurons(torch.from_numpy(w)).numpy(),
        np.asarray(jsim.augment_neurons(jnp.asarray(w))))
    np.testing.assert_array_equal(
        tsim.augment_queries(torch.from_numpy(w)).numpy(),
        np.asarray(jsim.augment_queries(jnp.asarray(w))))


def test_unit_matches(case):
    w, _, jax_out, _ = case
    assert_close(tsim.unit(torch.from_numpy(w)), jax_out["unit"],
                 rtol=1e-6, atol=1e-7, what="unit")
    zero = tsim.unit(torch.zeros(2, 3))
    assert torch.equal(zero, torch.zeros(2, 3))


def test_hash_bits_and_bucket_ids_exact(case):
    w, theta, jax_out, _ = case
    tw, tth = torch.from_numpy(w), torch.from_numpy(theta)
    assert_ints_equal(tsim.hash_bits(tw, tth), jax_out["bits"], what="bits")
    b = tsim.bucket_ids(tw, tth, K, L)
    assert b.dtype == torch.int32 and b.shape == (M, L)
    assert_ints_equal(b, jax_out["buckets"], what="bucket_ids")


def test_soft_codes_close(case):
    w, theta, jax_out, _ = case
    assert_close(tsim.soft_codes(torch.from_numpy(w), torch.from_numpy(theta)),
                 jax_out["soft"], rtol=1e-5, atol=1e-6, what="soft_codes")


@pytest.mark.parametrize("k_bits,n_tables", [(1, 1), (4, 2), (9, 1), (3, 5)])
def test_pack_bits_exact(k_bits, n_tables):
    rng = np.random.default_rng(k_bits * 10 + n_tables)
    bits = rng.random((13, k_bits * n_tables)) > 0.5
    assert_ints_equal(
        tsim.pack_bits(torch.from_numpy(bits), k_bits, n_tables),
        np.asarray(jsim.pack_bits(jnp.asarray(bits), k_bits, n_tables)),
        what="pack_bits")


def test_build_tables_exact(case):
    _, _, jax_out, tt = case
    assert tt.table_ids.dtype == torch.int32
    assert tt.table_ids.shape == (L, 2 ** K, CAP)
    assert (tt.k_bits, tt.n_tables, tt.capacity, tt.n_buckets) == \
        (K, L, CAP, 2 ** K)
    assert_ints_equal(tt.table_ids, jax_out["table_ids"], what="table_ids")
    assert_ints_equal(tt.n_dropped, jax_out["n_dropped"], what="n_dropped")
    assert int(tt.n_dropped.sum()) > 0     # the overflow path ran


def test_bucketize_weights_close(case):
    w, _, jax_out, tt = case
    wb = ttab.bucketize_weights(torch.from_numpy(w), tt)
    assert wb.shape == (L, 2 ** K, CAP, D)
    assert_close(wb, jax_out["wb"], rtol=0, atol=0, what="bucketize")


def test_bucket_load_stats_equal(case):
    _, _, jax_out, tt = case
    stats = ttab.bucket_load_stats(tt)
    assert set(stats) == set(jax_out["stats"])
    for k, v in stats.items():
        assert_close(v, jax_out["stats"][k], rtol=1e-6, atol=0, what=k)


def test_init_hyperplanes_seeded_on_cpu():
    a = tsim.init_hyperplanes(torch.Generator().manual_seed(3), 17, 4, 2,
                              device="cpu")
    b = tsim.init_hyperplanes(torch.Generator().manual_seed(3), 17, 4, 2,
                              device="cpu")
    assert a.shape == (17, 8) and a.dtype == torch.float32
    assert a.device.type == "cpu" and torch.equal(a, b)
