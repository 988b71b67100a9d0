"""Dry-run: trace every (arch x shape x mesh) cell on a fake fleet of 256
or 512 ranks and read its per-device roofline (counterpart of
``repro.launch.dryrun``).

Where the JAX module fakes 512 XLA host devices and compiles each cell,
this one starts a fake process group (``init_process_group("fake",
world_size=256 or 512, store=FakeStore())``: collectives return at
once, with the shapes a real fleet's would have), builds the cell on the
production mesh (``launch.mesh.make_production_mesh``), lays its args out
as ``DTensor``s over fake local tensors (no memory), and runs ``fn`` once
under :class:`DeviceCounter`, a ``FakeTensorMode`` that counts what this
rank (rank 0) would do:

* flops: each op's local work.  ``DTensor`` runs each op on the local
  shards, and those local ops are what the counter sees, so a
  ``[256, 4096] @ [4096, 151936]`` split 16 x 16 counts 1/256 of the
  global product; the shadow computation at global shapes by which
  ``DTensor`` infers an op's output metadata is run outside the counter.
  Products (``torch.utils.flop_counter``'s formulas) count in their
  input's dtype (bf16 at the BF16 tensor-core peak, fp32 at the FP32
  peak); pointwise ops count one flop an output element and reductions
  one an input element, at the FP32 peak.
* bytes: each op's tensor inputs read and outputs written, once each;
  views, allocations and metadata ops are free, a gather reads only the
  rows it returns and an in-place scatter touches only its rows.  That
  is what eager execution moves (no fusion), an upper bound on what a
  fused program would move.
* kernel ops (``torch.ops.repro_torch.*``: the card's route, one op a
  launch): their registered cost (``kernels.registry.op_cost``) in place
  of both.
* collectives: every ``c10d`` op the trace issues, its result's bytes on
  this rank and its group's ranks, ring-accounted by
  ``launch.roofline``; over NVLink where the group fits in a node of 8.
* memory: the args' local bytes, and the peak of live tensors (the args
  included) from ``torch.distributed._tools.mem_tracker.MemTracker``.

LM cells trace at full depth (the layers are a Python loop, every layer
and attention chunk is counted), but for the 32k-token prefill cells:
their blockwise attention runs 16 x 64 chunk steps a layer, ~25k traced
ops a layer (~25 s a layer on one core), so they trace at 1 and 2 layers
and extrapolate each count (and the peak memory) linearly to full depth,
as the JAX module does for every LM cell (``method`` says which).

The fake group is global to the process: :func:`start_fake_fleet`
replaces any group the process has.  Tests run the dry-run in a
subprocess.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --mesh both \
      --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
from collections import Counter, defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import all_cells, get_config
from repro_torch.kernels import registry as kernel_registry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import collective_stats, roofline_from_terms
from repro_torch.launch.steps import Cell, build_cell, tensor_map
from repro_torch.utils.sharding import (contiguous_stride, shard_range,
                                        use_mesh)
from repro_torch.utils.tree import tree_leaves

__all__ = ["DeviceCounter", "start_fake_fleet", "fake_args", "trace_cell",
           "run_cell", "main", "EXTRAPOLATED_KINDS"]

# c10d ops -> the roofline's collective names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "_softmax", "_log_softmax", "softmax",
               "log_softmax", "norm", "linalg_vector_norm", "var_mean",
               "cumsum", "argmax", "argmin", "topk", "sort", "argsort"}
# gathers read only the rows they return (and their indices); in-place
# scatters read and write only the rows they touch
_GATHERS = {"embedding", "index", "index_select", "gather",
            "take_along_dim"}
_SCATTERS = {"index_put_", "index_add_", "scatter_", "scatter_add_",
             "scatter_reduce_", "_index_put_impl_"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "wait_tensor", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "device",
         "_local_scalar_dense", "set_", "resize_"}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> list[int]:
    """The ranks of the group a c10d op runs over: a functional op names
    its group, a c10d op takes it boxed."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (KeyError, ValueError, RuntimeError):
                continue                    # a reduce op's name
        if type(a).__name__ == "ScriptObject":
            try:
                return dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(a))
            except RuntimeError:
                continue                    # a boxed reduce op
    raise ValueError("a collective with no process group")


class DeviceCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts the per-device work of every op it
    runs outside its own decompositions (see the module docstring):
    ``flops`` by dtype, ``bytes``, ``collectives`` (``(op, result bytes,
    group ranks)``) and ``kernels`` (calls of each kernel op)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops: dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.collectives: list[tuple[str, float, list[int]]] = []
        self.kernels: Counter = Counter()
        self.counting = False
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is not NotImplemented and self.counting and self._depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._opname
        ns = func.namespace
        if ns == kernel_registry.NAMESPACE:
            flops, nbytes = kernel_registry.op_cost(name, *args, **kwargs)
            for dt, f in flops.items():
                self.flops[dt] += f
            self.bytes += nbytes
            self.kernels[name] += 1
            return
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            op = _COLLECTIVES.get(name)
            if op is not None:
                outs = _tensors(out) or _tensors(args[:1])
                size = sum(_nbytes(t) for t in outs)
                if name in ("allgather_",):          # list-of-lists output
                    size = sum(_nbytes(t) for t in _tensors(args[0]))
                self.collectives.append((op, float(size),
                                         _group_ranks(args)))
            return
        if name in _FREE or func.is_view or ns == "prim":
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _GATHERS:
            # the source's rows read are the output's bytes
            self.bytes += (sum(_nbytes(t) for t in ins[1:])
                           + 2 * sum(_nbytes(t) for t in outs))
        elif name in _SCATTERS:
            self.bytes += 3 * sum(_nbytes(t) for t in ins[1:])
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                             for t in outs)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            self.flops[dt] += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops["pointwise"] += float(sum(t.numel() for t in outs))
        elif name.rstrip("_") in _REDUCTIONS:
            self.flops["pointwise"] += float(sum(t.numel() for t in ins))


@contextlib.contextmanager
def _shadow_outside(counter: DeviceCounter):
    """``DTensor`` infers an op's output metadata by running the op on
    fake tensors of the GLOBAL shapes; run that with every mode of the
    stack put aside (a fresh fake mode of its own), so neither the
    counter nor the memory tracker sees it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        ShardingPropagator._propagate_tensor_meta_cached.cache_clear()
    except AttributeError:
        pass
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def start_fake_fleet(world_size: int) -> None:
    """Make this process rank 0 of a fake group of ``world_size`` ranks
    (replacing any group it has)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def fake_args(cell: Cell):
    """``cell.args`` laid out by ``cell.in_shardings`` as ``DTensor``s over
    fake local tensors of this rank's shard shapes (0-d leaves plain, as
    ``NamedSharding.place`` leaves them).  Call inside a fake mode."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        if t.dim() == 0:
            return torch.empty((), dtype=t.dtype)
        pl = sh.placements(t.dim())
        local = []
        for d, n in enumerate(t.shape):
            lo, hi = shard_range(n, sh.mesh, pl, d)
            local.append(hi - lo)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype), sh.mesh,
                                  pl, run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))

    return tensor_map(one, cell.args, cell.in_shardings)


def _local_bytes(args) -> int:
    from repro_torch.utils.sharding import to_local
    return sum(_nbytes(to_local(t)) for t in _tensors(args))


def trace_cell(cell: Cell, mesh) -> dict:
    """Run ``cell.fn`` once on fake args over ``mesh`` under a
    :class:`DeviceCounter`: this rank's flops by dtype, bytes, collectives,
    kernel calls, and memory (args and peak bytes)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    counter = DeviceCounter()
    with counter, _shadow_outside(counter):
        args = fake_args(cell)
        arg_bytes = _local_bytes(args)
        mt = MemTracker()
        mt.track_external(*[t for t in _tensors(args)])
        counter.counting = True
        with mt, use_mesh(mesh):
            out = cell.fn(*args)
        counter.counting = False
        snap = mt.get_tracker_snapshot("peak")
        peak = max((v.get("Total", 0) for v in snap.values()), default=0)
        out_bytes = _local_bytes(out)
    return {"flops_by_dtype": dict(counter.flops), "bytes": counter.bytes,
            "collectives": counter.collectives,
            "kernels": dict(counter.kernels),
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "peak_bytes": int(peak)}


# shape kinds traced at 1 and 2 layers and extrapolated (see above)
EXTRAPOLATED_KINDS = ("prefill",)


def _extrapolate(one: dict, two: dict, depth: int) -> dict:
    """Each count of a 1- and a 2-layer trace taken on to ``depth``
    layers: ``one + (two - one) * (depth - 1)``; the collectives of the
    second layer repeated."""
    k = depth - 1

    def lin(a, b):
        return a + (b - a) * k

    dts = set(one["flops_by_dtype"]) | set(two["flops_by_dtype"])
    n1 = len(one["collectives"])
    layer = two["collectives"][n1:] if len(two["collectives"]) > n1 else []
    return {
        "flops_by_dtype": {dt: lin(one["flops_by_dtype"].get(dt, 0.0),
                                   two["flops_by_dtype"].get(dt, 0.0))
                           for dt in dts},
        "bytes": lin(one["bytes"], two["bytes"]),
        "collectives": one["collectives"] + layer * k,
        "kernels": two["kernels"],
        "argument_bytes": int(lin(one["argument_bytes"],
                                  two["argument_bytes"])),
        "output_bytes": int(lin(one["output_bytes"], two["output_bytes"])),
        "peak_bytes": int(lin(one["peak_bytes"], two["peak_bytes"])),
    }


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str | None, *, mesh=None, lm_layers=None,
             dims=None) -> dict:
    """Trace one cell on the production mesh (``mesh`` in its place, over
    a fleet the caller started) and return (and write under ``out_dir``)
    its record: memory, cost, collectives, roofline, timings, comment,
    method."""
    t0 = time.time()
    if mesh is None:
        start_fake_fleet(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    tag_mesh = "x".join(str(s) for s in mesh.mesh.shape)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": tag_mesh}
    cell = build_cell(arch_id, shape_name, mesh, lm_layers=lm_layers,
                      dims=dims)
    t1 = time.time()
    spec = get_config(arch_id)
    depth = spec.model_cfg.n_layers if spec.family == "lm" else None
    if (lm_layers is None and depth is not None and depth > 2
            and spec.shape(shape_name).kind in EXTRAPOLATED_KINDS):
        one = trace_cell(build_cell(arch_id, shape_name, mesh, lm_layers=1,
                                    dims=dims), mesh)
        two = trace_cell(build_cell(arch_id, shape_name, mesh, lm_layers=2,
                                    dims=dims), mesh)
        tr = _extrapolate(one, two, depth)
        rec["method"] = (f"fake fleet, traced at 1 and 2 layers, "
                         f"extrapolated to {depth}; per-device counts")
    else:
        tr = trace_cell(cell, mesh)
        rec["method"] = ("fake fleet, one traced call at full depth, "
                         "per-device counts")
    coll = collective_stats(tr["collectives"])
    rec["memory"] = {
        "argument_bytes": tr["argument_bytes"],
        "output_bytes": tr["output_bytes"],
        "peak_bytes": tr["peak_bytes"],
        "total_per_device_gb": round(tr["peak_bytes"] / 2 ** 30, 3),
    }
    flops = sum(tr["flops_by_dtype"].values())
    rec["cost"] = {"flops": flops, "flops_by_dtype": tr["flops_by_dtype"],
                   "bytes_accessed": tr["bytes"], "kernels": tr["kernels"]}
    rec["collectives"] = {
        "bytes_by_op": coll.bytes_by_op,
        "count_by_op": coll.count_by_op,
        "bytes_by_link": coll.bytes_by_link,
        "total_bytes_per_device": coll.total_bytes,
    }
    roof = roofline_from_terms(tr["flops_by_dtype"], tr["bytes"],
                               coll.bytes_by_link, n_dev, cell.model_flops)
    rec["roofline"] = roof.as_dict()
    rec["timings"] = {"build_s": round(t1 - t0, 1),
                      "trace_s": round(time.time() - t1, 1),
                      "total_s": round(time.time() - t0, 1)}
    rec["comment"] = cell.comment
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_id}_{shape_name}_{tag_mesh.replace('x', '_')}"
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()
    # DTensor warns at each two-dim reduction that one flattened group
    # would do it in one collective; the counts say so already
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    cells = all_cells()
    if args.arch != "all":
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape != "all":
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for mp in meshes:
        for arch_id, shape_name in cells:
            tag = f"{arch_id}/{shape_name}/{'multi' if mp else 'single'}"
            try:
                rec = run_cell(arch_id, shape_name, mp, args.out)
                r = rec["roofline"]
                print(f"[dryrun] OK  {tag}: "
                      f"mem={rec['memory']['total_per_device_gb']}GB "
                      f"t_comp={r['t_compute']:.2e}s "
                      f"t_mem={r['t_memory']:.2e}s "
                      f"t_coll={r['t_collective']:.2e}s "
                      f"bound={r['bottleneck']} "
                      f"useful={r['useful_ratio']:.2f} "
                      f"({rec['timings']['total_s']}s)",
                      flush=True)
            except Exception as e:                   # noqa: BLE001
                failures.append((tag, repr(e)))
                print(f"[dryrun] FAIL {tag}: {e!r}", flush=True)
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(meshes)} cells OK")


if __name__ == "__main__":
    main()
