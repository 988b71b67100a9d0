"""``simhash_codes``: the port's plain version against the JAX ``ref``
impl (exact codes), and its dispatch on CPU tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.simhash_codes import simhash_codes as j_codes  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.simhash_codes import simhash_codes  # noqa: E402
from repro_torch.kernels.simhash_codes.ops import simhash_codes_cuda  # noqa: E402
from repro_torch.kernels.simhash_codes.ref import simhash_codes_ref  # noqa: E402
from repro_torch.testing.parity import assert_ints_equal, margin_rows  # noqa: E402

SHAPES = [(64, 129, 9, 1), (48, 33, 4, 3)]   # (B, d, K, L)


def _inputs(bsz, d, k_bits, n_tables):
    rng = np.random.default_rng(bsz + d)
    x = rng.normal(size=(bsz, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)   # callers pass unit rows
    theta = rng.normal(size=(d, k_bits * n_tables)).astype(np.float32)
    return x, theta


@pytest.mark.parametrize("bsz,d,k_bits,n_tables", SHAPES)
def test_ref_matches_jax_exact(bsz, d, k_bits, n_tables):
    x, theta = _inputs(bsz, d, k_bits, n_tables)
    rows = margin_rows(x, theta)
    assert rows.all()
    want = np.asarray(j_codes(jnp.asarray(x), jnp.asarray(theta), k_bits,
                              n_tables, impl="ref"))
    got = simhash_codes(torch.from_numpy(x), torch.from_numpy(theta), k_bits,
                        n_tables)
    assert got.dtype == torch.int32 and got.shape == (bsz, n_tables)
    assert_ints_equal(got, want, rows=rows, what="simhash_codes")
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** k_bits


def test_cpu_tensors_dispatch_to_ref():
    x, theta = _inputs(*SHAPES[1])
    registry.reset_dispatch_log()
    launches = simhash_codes_cuda.launches
    out = simhash_codes(torch.from_numpy(x), torch.from_numpy(theta), 4, 3)
    assert registry.last_dispatch("simhash_codes") == "ref"
    assert simhash_codes_cuda.launches == launches      # no kernel launch
    assert torch.equal(out, simhash_codes_ref(torch.from_numpy(x),
                                              torch.from_numpy(theta), 4, 3))


def test_explicit_cuda_on_cpu_tensors_raises():
    x, theta = _inputs(*SHAPES[1])
    with pytest.raises(RuntimeError, match="no fallback"):
        simhash_codes(torch.from_numpy(x), torch.from_numpy(theta), 4, 3,
                      impl="cuda")


def test_zero_score_gives_bit_zero():
    # a bit is score > 0, strictly: a zero row hashes to bucket 0
    theta = torch.ones(5, 6)
    assert torch.equal(simhash_codes_ref(torch.zeros(2, 5), theta, 3, 2),
                       torch.zeros(2, 2, dtype=torch.int32))
