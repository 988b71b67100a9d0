"""``simhash_codes``: the port's plain version against the JAX ``ref``
impl (exact codes), and its dispatch on CPU tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.simhash_codes import simhash_codes as j_codes  # noqa: E402
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels.simhash_codes import simhash_codes  # noqa: E402
from repro_torch.kernels.simhash_codes.ops import (  # noqa: E402
    simhash_codes_cuda, simhash_codes_plan)
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


# ---------------------------------------------- the kernel's launch plan --

@pytest.mark.parametrize("bsz,k_bits,n_tables,rows,blocks", [
    (1, 9, 1, 1, 1), (256, 9, 1, 1, 256), (1024, 9, 1, 7, 147),
    (1024, 8, 4, 7, 147), (1000, 8, 4, 7, 143), (5000, 4, 3, 8, 625)])
def test_plan(bsz, k_bits, n_tables, rows, blocks):
    """Rows a block: B // 132, 1..8, so the grid covers the H100's SMs at
    B = 256; theta's rows padded to an odd stride (32 banks a column)."""
    plan = simhash_codes_plan(bsz, 129, k_bits, n_tables)
    assert (plan.rows, plan.blocks) == (rows, blocks)
    assert plan.blocks * plan.rows >= bsz > (plan.blocks - 1) * plan.rows
    kl = k_bits * n_tables
    assert plan.stride in (kl, kl + 1) and plan.stride % 2 == 1
    assert plan.smem == 4 * (129 * plan.stride + plan.rows * 129)
    assert plan.smem <= _build.SMEM_LIMIT_BYTES
    # lanes read column c of rows i = lane + 32 m: 32 different banks
    assert len({(i * plan.stride) % 32 for i in range(32)}) == 32


def _shfl_down_tree(p):
    """simhash_score's reduction of 32 fp32 partials: five
    __shfl_down_sync steps (16, 8, 4, 2, 1), lane 0's sum."""
    v = p.copy()
    for off in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[off:], np.zeros(off, np.float32)])
    return v[0]


def _warp_sum8(a):
    """warp_sum8 (csrc/warp_reduce.cuh) on a[lane][u], 32 x 8 fp32: the
    transposed butterfly.  Returns each lane's sum."""
    lanes = np.arange(32)
    h16, h8, h4 = lanes & 16 > 0, lanes & 8 > 0, lanes & 4 > 0
    keep = np.where(h16[:, None], a[:, 4:], a[:, :4])
    send = np.where(h16[:, None], a[:, :4], a[:, 4:])
    b = keep + send[lanes ^ 16]
    keep = np.where(h8[:, None], b[:, 2:], b[:, :2])
    send = np.where(h8[:, None], b[:, :2], b[:, 2:])
    c = keep + send[lanes ^ 8]
    e = np.where(h4, c[:, 1], c[:, 0]) + np.where(h4, c[:, 0], c[:, 1])[
        lanes ^ 4]
    e = e + e[lanes ^ 2]
    return e + e[lanes ^ 1]


def test_table_code_sums_each_score_as_simhash_score():
    """simhash_table_code reduces 8 scores at once with warp_sum8; lane 4u
    holds score u, bit for bit the sum simhash_score (lss_topk's stage 1)
    and the first port got from the same lane partials.  So the kernel's
    codes, and lss_topk's buckets, do not move."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = (rng.normal(size=(32, 8)) * 10.0 ** rng.integers(-3, 3)
             ).astype(np.float32)
        got = _warp_sum8(a)
        for u in range(8):
            want = _shfl_down_tree(a[:, u])
            lanes = [lane for lane in range(32) if (lane >> 2) & 7 == u]
            assert all(got[lane].tobytes() == want.tobytes() for lane in lanes)
