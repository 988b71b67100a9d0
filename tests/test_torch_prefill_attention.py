"""The prefill-attention op: on the CPU its plain version is
``attention_blockwise`` bit for bit, the CUDA wrapper's checks run before
any launch, and the op is registered with its cost and shape; on the card
(``gpu``) the kernel against the plain version at the served shapes and
the reduced ones, a row's bits independent of the prompt's length, and the
transformer's prefill launching it once a layer while training does not.

The ``gpu`` tests import no JAX, so they run where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_prefill_attention.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    prefill_attention)
from repro_torch.kernels.prefill_attention.ops import (  # noqa: E402
    prefill_attention_cuda)
from repro_torch.kernels.prefill_attention.ref import (  # noqa: E402
    prefill_attention_ref)
from repro_torch.models import layers as L  # noqa: E402


def _qkv(seed, s, n, kv, h, dtype, device="cpu", b=1):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)

    return draw(b, s, n, h), draw(b, s, kv, h), draw(b, s, kv, h)


# --------------------------------------------------------------- the CPU --

@pytest.mark.parametrize("s,n,kv,h,kv_chunk,q_chunk,dtype", [
    (96, 14, 2, 64, 512, 2048, torch.bfloat16),    # Qwen2-0.5B's heads
    (60, 4, 1, 16, 32, 64, torch.float32),         # the reduced configs
    (256, 4, 1, 16, 32, 64, torch.float32),        # query chunks
    (130, 16, 16, 128, 512, None, torch.bfloat16),  # r = 1, S odd
])
def test_plain_version_is_attention_blockwise_bit_for_bit(s, n, kv, h,
                                                          kv_chunk, q_chunk,
                                                          dtype):
    q, k, v = _qkv(s, s, n, kv, h, dtype, b=2)
    want = L.attention_blockwise(q, k, v, causal=True, kv_chunk=kv_chunk,
                                 q_chunk=q_chunk)
    before = prefill_attention_cuda.launches
    got = prefill_attention(q, k, v, kv_chunk, q_chunk)
    assert registry.last_dispatch("prefill_attention") == "ref"
    assert got.dtype == dtype and torch.equal(got, want)
    assert prefill_attention_cuda.launches == before


def _good(s=40, n=14, kv=2, h=64, dtype=torch.bfloat16):
    return dict(q=torch.zeros(2, s, n, h, dtype=dtype),
                k=torch.zeros(2, s, kv, h, dtype=dtype),
                v=torch.zeros(2, s, kv, h, dtype=dtype),
                kv_chunk=512, q_chunk=2048)


def _cast(**kw):
    a = _good()
    a.update({key: a[key].to(t) for key, t in kw.items()})
    return a


_BAD = {
    "q_float16": (lambda: _cast(q=torch.float16), "share one dtype"),
    "k_float32": (lambda: _cast(k=torch.float32), "share one dtype"),
    "all_float16": (lambda: _cast(q=torch.float16, k=torch.float16,
                                  v=torch.float16), "share one dtype"),
    "q_3d": (lambda: {**_good(), "q": torch.zeros(
        40, 14, 64, dtype=torch.bfloat16)}, "are not"),
    "k_v_differ": (lambda: {**_good(), "v": torch.zeros(
        2, 40, 1, 64, dtype=torch.bfloat16)}, "do not fit"),
    "lengths_differ": (lambda: {**_good(), "k": torch.zeros(
        2, 39, 2, 64, dtype=torch.bfloat16)}, "do not fit"),
    "head_dim_32": (lambda: _good(h=32), "head_dim 32"),
    "head_dim_24": (lambda: _good(h=24), "head_dim 24"),
    "head_dim_256": (lambda: _good(h=256), "head_dim 256"),
    "ratio_not_whole": (lambda: _good(n=6, kv=4), "ratio"),
    "ratio_17": (lambda: _good(n=34, kv=2), "ratio"),
    "empty_prompt": (lambda: _good(s=0), "positions"),
    "q_not_contiguous": (lambda: {**_good(), "q": torch.zeros(
        2, 14, 40, 64, dtype=torch.bfloat16).transpose(1, 2)},
        "contiguous"),
    "k_not_contiguous": (lambda: {**_good(), "k": torch.zeros(
        2, 2, 40, 64, dtype=torch.bfloat16).transpose(1, 2)},
        "contiguous"),
    "q_misaligned": (lambda: {**_good(), "q": torch.zeros(
        2 * 40 * 14 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 40, 14, 64)},
        "aligned"),
    "q_requires_grad": (lambda: {**_good(), "q": torch.zeros(
        2, 40, 14, 64, dtype=torch.bfloat16, requires_grad=True)},
        "no backward"),
    "cpu_tensors": (_good, "CUDA tensor"),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
    """The CUDA wrapper's checks run before it launches or builds
    anything; on CPU tensors that pass them it refuses the device."""
    make, match = _BAD[name]
    before = prefill_attention_cuda.launches
    with pytest.raises(ValueError, match=match):
        prefill_attention_cuda(**make())
    assert prefill_attention_cuda.launches == before


def test_inputs_that_require_grad_pass_the_checks_under_no_grad():
    """The gradient check reads the grad mode: a prefill under no_grad
    (the serving path's) goes on to the device check."""
    a = {**_good(), "q": torch.zeros(2, 40, 14, 64, dtype=torch.bfloat16,
                                     requires_grad=True)}
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        prefill_attention_cuda(**a)


def test_the_op_is_registered_with_its_cost_and_shape():
    op = registry.get_op("prefill_attention")
    assert set(op.impls) == {"ref", "cuda"}
    a = _good()
    with pytest.raises(RuntimeError, match="no fallback"):
        prefill_attention(**a, impl="cuda")
    flops, nbytes = registry.op_cost("prefill_attention", *a.values())
    b, s, n, h = a["q"].shape
    assert flops == {"bfloat16": 4.0 * b * n * h * s * (s + 1) / 2}
    assert nbytes == 2 * (2 * a["q"].numel() + 2 * a["k"].numel())
    meta = {key: (t.to("meta") if isinstance(t, torch.Tensor) else t)
            for key, t in a.items()}
    out = prefill_attention(**meta)
    assert out.is_meta and out.shape == a["q"].shape
    assert out.dtype == a["q"].dtype


# -------------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_an_ulp(got, want, mag, dtype):
    """bf16: each output within one bf16 ulp of the plain value, beyond
    what two fp32 computations of it may differ by: 2^-19 of
    ``mag`` = sum_j p_j |v_j| (32 units of 2^-24 of the terms' size; on an
    H100 at these shapes the plain version lies up to 21.5 such units from
    float64, the kernel up to 15.4 from the plain version beyond its ulp).
    Where an output is no cancellation (``mag`` ~ |output|) that is 1/16
    of an ulp.  fp32: within 1e-5 of the (row, head)'s largest
    |output|."""
    g, w = got.float(), want.float()
    if dtype == torch.bfloat16:
        ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp(
            min=2.0 ** -120))) - 7)
        limit = ulp + 2.0 ** -19 * mag.float()
    else:
        limit = 1e-5 * w.abs().amax(-1, keepdim=True)
    bad = (g - w).abs() > limit
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} outputs off; worst "
        f"{float(((g - w).abs() / limit).max())} of its limit")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [8, 96, 1024, 4096])
@pytest.mark.parametrize("heads", [(14, 2, 64), (16, 16, 128),
                                   (32, 8, 128), (4, 2, 16)])
def test_kernel_matches_plain(cuda, heads, s, dtype):
    """The kernel against its plain version (the model's chunks: kv 512,
    q 2,048) at Qwen2-0.5B's and Qwen1.5-MoE's heads, a wide GQA and the
    reduced configs' head size; the same bits again on the same inputs."""
    n, kv, h = heads
    q, k, v = _qkv(s * n + h, s, n, kv, h, dtype, cuda)
    before = prefill_attention_cuda.launches
    got = prefill_attention(q, k, v, 512, 2048)
    assert prefill_attention_cuda.launches == before + 1
    want = prefill_attention_ref(q, k, v, 512, 2048)
    mag = prefill_attention_ref(q, k, v.abs(), 512, 2048)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _within_an_ulp(got, want, mag, dtype)
    again = prefill_attention(q, k, v, 512, 2048)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_row_is_the_same_bits_at_any_prompt_length(cuda, dtype):
    """The first 2,048 rows of a 4,096-token prompt are the bits of the
    2,048-token prompt that is its head (and of 2,000 for its first 2,000):
    tiles at absolute positions, keys past a row never read into it."""
    q, k, v = _qkv(11, 4096, 14, 2, 64, dtype, cuda)
    full = prefill_attention(q, k, v, 512, 2048)
    for s in (2048, 2000):
        head = prefill_attention(q[:, :s].contiguous(), k[:, :s].contiguous(),
                                 v[:, :s].contiguous(), 512, 2048)
        torch.cuda.synchronize()
        assert torch.equal(head, full[:, :s]), s


def _reduced_qwen2(cuda):
    from repro_torch.configs.reduced import reduced_model_cfg
    from repro_torch.models import transformer as T
    cfg = reduced_model_cfg("qwen2-0.5b")
    params = T.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                           device=cuda)
    return T, cfg, params


@pytest.mark.gpu
def test_a_prefill_launches_the_kernel_once_a_layer(cuda):
    """The reduced qwen2 configuration's prefill on the card: one launch a
    layer, and its hidden state and cache the plain attention's within
    the fp32 kernel's tolerance."""
    T, cfg, params = _reduced_qwen2(cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    before = prefill_attention_cuda.launches
    with torch.no_grad():
        hidden, cache = T.prefill(params, tokens, cfg, max_len=160)
    torch.cuda.synchronize()
    assert prefill_attention_cuda.launches == before + cfg.n_layers
    assert hidden.shape == (2, 128, cfg.d_model)
    assert cache.k.shape == (cfg.n_layers, 2, 160, cfg.n_kv_heads,
                             cfg.head_dim)
    with torch.no_grad():
        want, _, _ = T.forward(params, tokens, cfg, mode="train")
    torch.cuda.synchronize()
    err = float((hidden - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.gpu
def test_a_training_forward_stays_blockwise_with_its_gradient(cuda):
    T, cfg, params = _reduced_qwen2(cuda)
    for p in params["layers"].values():
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 33))).to(cuda)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    before = prefill_attention_cuda.launches
    loss = T.lm_loss(params, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    assert prefill_attention_cuda.launches == before
    grad = params["layers"]["wq"].grad
    assert grad is not None and bool(grad.abs().sum() > 0)
