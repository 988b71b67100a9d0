"""The dry-run (``repro_torch.launch.dryrun``) and the roofline
(``repro_torch.launch.roofline``) on the CPU.

* The counter: a ``[m, k] @ [k, n]`` product counts 2mkn flops and
  (mk + kn + mn) * itemsize bytes on one device; split over ``model`` by
  its columns on a fake (2, 2) mesh, half the flops a device (and
  mk + kn/2 + mn/2 elements of bytes).
* Each kernel op counts its registered cost, once a call; ``lss_topk``'s
  cost is at least ``chip_smoke.py``'s data-aware bound on random data.
* The ring accounting equals JAX's ``parse_collectives`` on synthetic HLO
  lines of all five collectives; ``useful_ratio`` equals JAX's
  ``roofline_from_terms``; the H100 constants are the datasheet's.
* ``run_cell`` on JAX's three mini dry-run cells (qwen2-0.5b decode_32k
  at 2 layers, deepfm serve_p99, gcn-cora molecule) on a fake (2, 2)
  fleet, and deepfm serve_p99 on the 16 x 16 production mesh: flops > 0,
  collectives (every one of them shards a leaf), a memory record.  The
  fake group is global to a process, so these run in a subprocess.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.core.lss import LSSConfig, build_index  # noqa: E402
from repro_torch.core.simhash import (augment_neurons,  # noqa: E402
                                      augment_queries, init_hyperplanes)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.bucket_logits.ops import bucket_logits  # noqa: E402
from repro_torch.kernels.lss_topk.ops import lss_topk  # noqa: E402
from repro_torch.kernels.prefill_attention.ops import (  # noqa: E402
    prefill_attention)
from repro_torch.kernels.simhash_codes.ops import simhash_codes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import DeviceCounter  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_matmul_counts_flops_and_bytes():
    m, k, n = 64, 96, 40
    counter = DeviceCounter()
    with counter:
        a, b = torch.empty(m, k), torch.empty(k, n)
        counter.counting = True
        a @ b
        counter.counting = False
    assert dict(counter.flops) == {"float32": 2.0 * m * k * n}
    assert counter.bytes == 4.0 * (m * k + k * n + m * n)


def _kernel_args():
    g = torch.Generator().manual_seed(0)
    m, d = 3000, 33
    w_aug = augment_neurons(torch.randn(m, d - 1, generator=g))
    cfg = LSSConfig(k_bits=6, n_tables=3, slab_dtype="fp32")
    theta = init_hyperplanes(g, d, cfg.k_bits, cfg.n_tables, device="cpu")
    index = build_index(w_aug, theta, cfg)
    q_aug = augment_queries(torch.randn(64, d - 1, generator=g))
    return index, q_aug


def test_kernel_ops_count_their_registered_cost():
    index, q_aug = _kernel_args()
    t = index.tables
    slabs = index.w_bucketed.reshape(-1, t.capacity, q_aug.shape[1])
    slab_ids = torch.zeros((q_aug.shape[0], t.n_tables), dtype=torch.int32)
    calls = {
        "lss_topk": ((q_aug, index.theta, t.table_ids, index.w_bucketed),
                     {"top_k": 5}, lss_topk),
        "simhash_codes": ((q_aug, index.theta, t.k_bits, t.n_tables), {},
                          simhash_codes),
        "bucket_logits": ((q_aug, slabs, slab_ids), {}, bucket_logits),
        "prefill_attention": ((torch.zeros(2, 96, 14, 64, dtype=torch.bfloat16),
                               torch.zeros(2, 96, 2, 64, dtype=torch.bfloat16),
                               torch.zeros(2, 96, 2, 64, dtype=torch.bfloat16),
                               512, 2048), {}, prefill_attention),
    }
    for name, (args, kwargs, call) in calls.items():
        counter = DeviceCounter()
        with counter:
            fake = [counter.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args]
            counter.counting = True
            call(*fake, **kwargs)
            counter.counting = False
        flops, nbytes = registry.op_cost(name, *args, **kwargs)
        assert counter.kernels == {name: 1}, name
        assert dict(counter.flops) == flops, name
        assert counter.bytes == nbytes, name


def test_lss_topk_cost_bounds_the_data_aware_bound():
    index, q_aug = _kernel_args()
    t = index.tables
    out = lss_topk(q_aug, index.theta, t.table_ids, index.w_bucketed,
                   top_k=5)
    _, _, nbytes, flops = chip_smoke.lss_topk_bound_ms(q_aug, index, out[3],
                                                       5)
    c_flops, c_bytes = registry.op_cost(
        "lss_topk", q_aug, index.theta, t.table_ids, index.w_bucketed,
        top_k=5)
    assert c_bytes >= nbytes and sum(c_flops.values()) >= flops
    assert nbytes > 0 and flops > 0


_HLO = {
    "all-reduce": "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
                  "replica_groups=[16,16]<=[256], to_apply=%add",
    "all-gather": "%ag = bf16[64,512]{1,0} all-gather(bf16[4,512]{1,0} %x), "
                  "replica_groups=[16,16]<=[256], dimensions={0}",
    "reduce-scatter": "%rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]"
                      "{1,0} %x), replica_groups={{0,1,2,3}}, "
                      "dimensions={0}, to_apply=%add",
    "all-to-all": "%aa = f32[32,32]{1,0} all-to-all(f32[32,32]{1,0} %x), "
                  "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
    "collective-permute": "%cp = s32[100]{0} collective-permute(s32[100]{0} "
                          "%x), source_target_pairs={{0,1},{1,0}}",
}
_SIZES = {"all-reduce": (4096, 16), "all-gather": (64 * 512 * 2, 16),
          "reduce-scatter": (8 * 128 * 4, 4), "all-to-all": (32 * 32 * 4, 8),
          "collective-permute": (400, 256)}


@pytest.mark.parametrize("op", list(_HLO))
def test_ring_accounting_equals_jax(op):
    want = jroofline.parse_collectives(_HLO[op], 256)
    size, g = _SIZES[op]
    got = roofline.collective_stats([(op, size, list(range(g)))])
    assert got.count_by_op == want.count_by_op == {op: 1}
    assert got.bytes_by_op[op] == pytest.approx(want.bytes_by_op[op],
                                                rel=1e-12)


def test_links_and_constants():
    assert roofline.link_of(range(8)) == "nvlink"
    assert roofline.link_of([0, 8]) == "network"
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_FP32, tmesh.HBM_BW,
            tmesh.NVLINK_BW, tmesh.NETWORK_BW) == (989e12, 67e12, 3.35e12,
                                                   450e9, 50e9)
    r = roofline.roofline_from_terms({"bfloat16": 989e12, "float32": 67e12},
                                     3.35e12, {"nvlink": 450e9,
                                               "network": 50e9}, 1, 1.0)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (2.0, 1.0, 2.0))


@pytest.mark.parametrize("terms", [(1e12, 2e9, 3e8, 256, 5e13),
                                   (7e14, 1e12, 0.0, 512, 1e17),
                                   (0.0, 1.0, 1.0, 4, 1.0)])
def test_useful_ratio_equals_jax(terms):
    flops, bts, coll, n_devices, model_flops = terms
    want = jroofline.roofline_from_terms(*terms)
    got = roofline.roofline_from_terms({"bfloat16": flops}, bts,
                                       {"network": coll}, n_devices,
                                       model_flops)
    assert got.useful_ratio == pytest.approx(want.useful_ratio, rel=1e-12)
    assert got.model_flops == want.model_flops


_RUN = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.dryrun import DeviceCounter
import torch

out = {}
dryrun.start_fake_fleet(4)
mesh = make_mesh((2, 2), ("data", "model"))
# a product split over model by its columns
counter = DeviceCounter()
from torch.distributed.tensor import DTensor, Replicate, Shard
m, k, n = 64, 96, 40
with counter, dryrun._shadow_outside(counter):
    a = DTensor.from_local(torch.empty(m, k), mesh,
                           [Replicate(), Replicate()], run_check=False)
    b = DTensor.from_local(torch.empty(k, n // 2), mesh,
                           [Replicate(), Shard(1)], run_check=False,
                           shape=(k, n), stride=(n, 1))
    counter.counting = True
    a @ b
    counter.counting = False
out["sharded_matmul"] = [dict(counter.flops), counter.bytes]
for arch, shape, layers in (("qwen2-0.5b", "decode_32k", 2),
                            ("deepfm", "serve_p99", None),
                            ("gcn-cora", "molecule", None)):
    out[f"2x2/{arch}/{shape}"] = dryrun.run_cell(
        arch, shape, False, sys.argv[1], mesh=mesh, lm_layers=layers)
out["16x16/deepfm/serve_p99"] = dryrun.run_cell("deepfm", "serve_p99",
                                                False, sys.argv[1])
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _RUN, str(d / "out"),
                        str(d / "runs.json")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.load(open(d / "runs.json")), d / "out"


def test_sharded_matmul_counts_half_the_flops(runs):
    flops, nbytes = runs[0]["sharded_matmul"]
    m, k, n = 64, 96, 40
    assert flops == {"float32": 2.0 * m * k * n / 2}
    assert nbytes == 4.0 * (m * k + k * n / 2 + m * n / 2)


@pytest.mark.parametrize("key", ["2x2/qwen2-0.5b/decode_32k",
                                 "2x2/deepfm/serve_p99",
                                 "2x2/gcn-cora/molecule",
                                 "16x16/deepfm/serve_p99"])
def test_run_cell_record(runs, key):
    rec = runs[0][key]
    mesh, arch, shape = key.split("/")
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, mesh)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["collectives"]["total_bytes_per_device"] > 0
    assert sum(rec["collectives"]["count_by_op"].values()) > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["t_compute"] > 0 and r["t_memory"] > 0 and r["t_collective"] > 0
    assert 0 < r["useful_ratio"]
    for field in ("timings", "comment", "method"):
        assert rec[field]
    if arch == "qwen2-0.5b":
        assert rec["cost"]["kernels"] == {"lss_topk": 1}
    tag = f"{arch}_{shape}_{mesh.replace('x', '_')}.json"
    assert json.load(open(runs[1] / tag)) == rec
