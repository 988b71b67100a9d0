"""The port's model zoo registry against the JAX package's: the ten arch
ids in the JAX order, each ``ArchSpec`` and each ``reduced_model_cfg``
field for field (dtypes mapped), the four synthetic generators of the zoo
bit for bit; and the two kernels' launch shapes at every registry width:
``lss_topk_layout`` and ``simhash_codes_plan`` fit an H100 block at each
LM's LSS head width (d_model + 1, its K, L and capacity), at each slab
dtype and at the serve launcher's K = 6, and the narrow ``lss_topk``
layout is unchanged wherever it fits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.reduced import reduced_model_cfg  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lss_topk.ops import lss_topk_layout  # noqa: E402
from repro_torch.kernels.simhash_codes.ops import simhash_codes_plan  # noqa: E402
from repro_torch.launch.serve import LSS_CONFIG  # noqa: E402

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
ZOO = ["arctic-480b", "qwen2-moe-a2.7b", "gcn-cora", "bert4rec", "dien",
       "deepfm", "autoint"]


def _fields(cfg):
    d = cfg._asdict()
    d["dtype"] = DTYPES.get(d["dtype"], d["dtype"])
    return d


def _port_fields(cfg):
    """A port config's fields less those the port alone has, each at the
    default that computes what the JAX package computes."""
    d = cfg._asdict()
    if "norm_topk_prob" in d:
        assert d.pop("norm_topk_prob") is True
    return d


def test_ten_ids_in_the_jax_order():
    assert registry.ALL_ARCHS == jregistry.ALL_ARCHS
    assert len(registry.ALL_ARCHS) == 10
    assert not hasattr(registry, "NOT_PORTED")


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_arch_spec_mirrors_jax(arch):
    j, t = jregistry.get_config(arch), registry.get_config(arch)
    assert (t.arch_id, t.family, t.notes) == (j.arch_id, j.family, j.notes)
    assert _fields(j.model_cfg) == _port_fields(t.model_cfg)
    assert type(t.model_cfg).__name__ == type(j.model_cfg).__name__
    assert t.model_cfg.param_count() == j.model_cfg.param_count()
    assert t.shapes == j.shapes and list(t.shapes) == list(j.shapes)
    assert (t.lss is None) == (j.lss is None)
    if t.lss is not None:
        assert t.lss._asdict() == j.lss._asdict()


@pytest.mark.parametrize("arch", jregistry.ALL_ARCHS)
def test_reduced_config_mirrors_jax(arch):
    j, t = jreduced.reduced_model_cfg(arch), reduced_model_cfg(arch)
    assert type(t).__name__ == type(j).__name__
    assert _fields(j) == _port_fields(t)
    assert t.param_count() == j.param_count()


def test_moe_active_params_mirror_jax():
    for arch in ("arctic-480b", "qwen2-moe-a2.7b"):
        j = jregistry.get_config(arch).model_cfg
        t = registry.get_config(arch).model_cfg
        assert t.active_param_count() == j.active_param_count()
        assert _port_fields(t.moe_cfg) == j.moe_cfg._asdict()


# ------------------------------------------------------------ the data --

def test_ctr_dataset_bit_for_bit():
    # the reference runs only where vocab_per_field <= n_fields (an unused
    # take_along_axis raises IndexError above that); the port runs at
    # every size
    for a, b in zip(syn.ctr_dataset(3, 200, 8, 6),
                    jsyn.ctr_dataset(3, 200, 8, 6)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(IndexError):
        jsyn.ctr_dataset(3, 20, 5, 1000)
    ids, labels = syn.ctr_dataset(3, 200, 5, 1000)
    assert ids.shape == (200, 5) and ids.dtype == np.int32
    assert ids.max() < 1000 and set(np.unique(labels)) <= {0, 1}


def test_seqrec_dataset_bit_for_bit():
    for a, b in zip(syn.seqrec_dataset(4, 20, 16, 500, n_clusters=10),
                    jsyn.seqrec_dataset(4, 20, 16, 500, n_clusters=10)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_graph_dataset_and_csr_bit_for_bit():
    a = syn.graph_dataset(5, 300, 1200, 16, 4)
    b = jsyn.graph_dataset(5, 300, 1200, 16, 4)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for x, y in zip(syn.to_csr(a["edges"], 300), jsyn.to_csr(b["edges"], 300)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ------------------------------------------ the kernels at every width --

def _lm_heads():
    """(arch, d_aug, K, L, P) of each registry LM's own LSS head, and of
    the serve launcher's K = 6 index on it."""
    out = []
    for arch in registry.ALL_ARCHS:
        spec = registry.get_config(arch)
        if spec.family != "lm":
            continue
        m = spec.model_cfg
        for lss in (spec.lss, LSS_CONFIG):
            out.append((arch, m.d_model + 1, lss.k_bits, lss.n_tables,
                        lss.resolve_capacity(m.vocab)))
    bert = registry.get_config("bert4rec")
    out.append(("bert4rec", bert.model_cfg.embed_dim + 1, bert.lss.k_bits,
                bert.lss.n_tables,
                bert.lss.resolve_capacity(bert.model_cfg.n_items)))
    return out


def _narrow_layout(d, k_bits, n_tables, cap, itemsize, scaled):
    """The layout before the wide one existed (``make_layout`` in
    ``csrc/lss_topk.cu`` as it was): (rows, stage, hash, smem, scratch),
    and whether q, theta and the rings fit in a block."""
    c = n_tables * cap
    row_bytes = d * itemsize
    rows = 4224 // row_bytes
    rows = rows - rows % 8 if rows >= 8 else max(rows, 1)
    stage = ((rows * row_bytes + 15) & ~15) + 32
    hash_entries = 2
    while hash_entries < 2 * c:
        hash_entries <<= 1
    kl = k_bits * n_tables
    ring = 8 * 2 * (8 + stage)
    vec = (4 * (2 * d + d * kl + 32 + 2 * n_tables + kl + 1) + 15) & ~15
    slot = (4 * c * (3 if scaled else 2) + 4 * hash_entries + 15) & ~15
    in_smem = ring + vec + slot <= 232_448
    return ((rows, stage, hash_entries, ring + vec + (slot if in_smem else 0),
             0 if in_smem else slot), ring + vec <= 232_448)


@pytest.mark.parametrize("slab_dtype,itemsize", [("fp32", 4), ("bf16", 2),
                                                 ("int8", 1)])
def test_lss_topk_layout_fits_every_registry_width(slab_dtype, itemsize):
    heads = _lm_heads()
    assert {h[0] for h in heads} >= {"arctic-480b", "qwen2-moe-a2.7b",
                                     "qwen2-7b", "qwen3-4b", "qwen2-0.5b"}
    n_wide = 0
    for arch, d, k_bits, n_tables, cap in heads:
        lay = lss_topk_layout(d, k_bits, n_tables, cap, slab_dtype)
        assert lay.smem <= _build.SMEM_LIMIT_BYTES, (arch, d, k_bits)
        old, fits = _narrow_layout(d, k_bits, n_tables, cap, itemsize,
                                   slab_dtype == "int8")
        assert lay.wide == (not fits), (arch, d, k_bits)
        if fits:                                   # unchanged
            assert tuple(lay[:5]) == old, (arch, d, k_bits)
        else:                              # one q and the small arrays
            n_wide += 1
            assert (lay.rows, lay.stage) == (8, 0)
            kl = k_bits * n_tables
            vec = (4 * (d + 32 + 2 * n_tables + kl + 1) + 15) & ~15
            slot = (4 * n_tables * cap * (3 if slab_dtype == "int8" else 2)
                    + 4 * lay.hash + 15) & ~15
            assert lay.smem == vec + (0 if lay.scratch else slot)
            assert lay.scratch in (0, slot)
    # arctic's width is wide at every dtype; qwen3-4b and qwen2-7b in fp32
    assert n_wide >= {"fp32": 3, "bf16": 2, "int8": 1}[slab_dtype]


def test_lss_topk_narrow_numbers_at_the_lm_widths():
    # q, q/|q|, theta, rings, ids, logits and hash table of one block at
    # each head's width, in the narrow layout
    assert lss_topk_layout(897, 10, 1, 304).smem == 108_016
    assert lss_topk_layout(2049, 10, 1, 304).smem == 230_512
    assert lss_topk_layout(2049, 10, 1, 304, "bf16").smem == 171_504
    assert lss_topk_layout(2561, 10, 1, 304, "bf16").smem == 212_464
    assert lss_topk_layout(65, 12, 1, 496).smem == 79_104
    for shape, dt in (((2561, 10, 1, 304), "fp32"),
                      ((3585, 10, 1, 304), "bf16"),
                      ((7169, 8, 1, 256), "int8")):
        assert lss_topk_layout(*shape, dt).wide
    assert not lss_topk_layout(3585, 10, 1, 304, "int8").wide


@pytest.mark.parametrize("bsz", [1, 8, 256, 4096])
def test_simhash_codes_plan_fits_every_registry_width(bsz):
    for arch, d, k_bits, n_tables, _ in _lm_heads():
        plan = simhash_codes_plan(bsz, d, k_bits, n_tables)
        assert plan.smem <= _build.SMEM_LIMIT_BYTES, (arch, d, bsz)
        kl = k_bits * n_tables
        whole = 4 * (d * plan.stride + plan.rows * d)
        if whole <= _build.SMEM_LIMIT_BYTES:         # unchanged
            assert plan.tile == 0 and plan.smem == whole
        else:                                        # d-tiles
            assert plan.tile % 32 == 0 and 32 <= plan.tile <= 1024
            assert plan.smem == 4 * (plan.tile * plan.stride
                                     + plan.rows * plan.tile)
        assert plan.stride in (kl, kl + 1) and plan.stride % 2 == 1
    # arctic's width is tiled at any batch
    assert simhash_codes_plan(bsz, 7169, 8, 1).tile > 0
