"""Sharding helpers (counterpart of ``repro.utils.sharding``): constraints
apply only when a mesh is active, so the same model code runs on one
device and on a ``(data, model)`` mesh of ranks.

The JAX ``PartitionSpec`` becomes :class:`P` (one entry a tensor dim:
``None``, an axis name, or a tuple of axis names), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims (``data``,
``model``): a spec gives each mesh dim a ``Shard(d)`` of the tensor dim
that names it, or ``Replicate()``.  A dim named by two axes is split by
the first, then each piece by the second, as JAX lays out ``("data",
"model")``.  Uneven dims split as ``torch.chunk`` does (the last rank's
piece is the short one), as ``DTensor`` splits them.

The active mesh is a context (:func:`use_mesh`), which the trainer enters
around its step and its checkpoint saves; outside it :func:`maybe_shard`
is the identity.  On a mesh of CUDA tensors over gloo (ranks sharing a
card: NCCL refuses two ranks on one GPU) the context also stages every
all-gather through host memory (:class:`HostStagedGather`): gloo runs the
other collectives on CUDA tensors, but its functional all-gather of a
CUDA tensor, which ``DTensor`` calls to replicate a shard, crashes the
process (measured with torch 2.11 on an H100).

The vocab-parallel pieces of the models live here too, so that the three
models share them: :func:`embedding` (a row-sharded table's lookup: each
rank looks up the ids it holds, the rows summed by one all-reduce later;
its gradient stays on the rank's rows), :func:`vocab_iota` and
:func:`logsumexp` (the local max and the local sum of exponentials, each
reduced over the vocab shards by one all-reduce of the batch's size).
Gathering the table or the logits whole is what they avoid: ``DTensor``'s
own ``logsumexp`` and ``gather`` all-gather the logits, and its embedding
gradient is a full-size partial table.  :class:`CollectiveLog` records
every collective a region runs, with its shapes and bytes.

``torch.distributed.tensor`` is imported when a mesh is first used, not
with this module: its import (with ``torch._dynamo``) took ~1.5 s here
and added ~7 s to each launcher process on the H100 machine, and no
``DTensor`` can exist before it is imported (:func:`is_dtensor`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import TYPE_CHECKING, Any, Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode

if TYPE_CHECKING:
    from torch.distributed.tensor import DTensor

__all__ = ["P", "is_dtensor", "HostStagedGather", "stages_gathers", "full_tensor",
           "use_mesh",
           "active_mesh", "mesh_axis_size", "maybe_shard",
           "NamedSharding", "named_sharding", "specs_to_shardings",
           "spec_placements", "shard_range", "place", "to_local", "map_local",
           "embedding", "vocab_iota", "logsumexp", "replicate",
           "contiguous_stride",
           "CollectiveLog"]


class P:
    """A partition spec: one entry a tensor dim (``None``, an axis name,
    or a tuple of axis names); missing trailing dims are ``None``.  Equal
    to a JAX ``PartitionSpec`` as a tuple (``tuple(p) == tuple(jspec)``).
    Not a tuple itself, so that a tree of specs has the specs as leaves."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self) -> Iterator:
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self.parts)) + ")"


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``, without importing the module."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dt():
    import torch.distributed.tensor as dt
    return dt


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


class HostStagedGather(TorchDispatchMode):
    """Runs each functional all-gather of a CUDA tensor through host
    memory: the input copied to the host, gathered there over the same
    group, the result copied back.  Every other op runs as it is.  It
    sees the collectives issued while it is active outside an op's
    dispatch (``redistribute``, ``full_tensor``, :func:`maybe_shard`), not
    those ``DTensor`` issues inside one to fit an op's inputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops._c10d_functional.all_gather_into_tensor.default
                and args[0].is_cuda):
            out = func(args[0].cpu(), *args[1:], **kwargs)
            out = torch.ops._c10d_functional.wait_tensor(out)
            return out.to(args[0].device)
        return func(*args, **kwargs)


def stages_gathers(mesh: DeviceMesh) -> bool:
    """True where ``mesh``'s all-gathers must be staged through the host:
    CUDA tensors over gloo."""
    return (mesh.device_type == "cuda"
            and dist.get_backend(mesh.get_group(0)) == "gloo")


def full_tensor(x) -> torch.Tensor:
    """The whole of ``x`` on every rank (an all-gather, staged through the
    host where :func:`stages_gathers`); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    with (HostStagedGather() if stages_gathers(x.device_mesh)
          else contextlib.nullcontext()):
        return x.full_tensor()


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None):
    """Make ``mesh`` the active mesh inside the block (None: no mesh);
    on a mesh that :func:`stages_gathers`, a :class:`HostStagedGather`
    is active too."""
    token = _MESH.set(mesh)
    try:
        if mesh is not None and stages_gathers(mesh):
            with HostStagedGather():
                yield mesh
        else:
            yield mesh
    finally:
        _MESH.reset(token)


def active_mesh() -> DeviceMesh | None:
    return _MESH.get()


def mesh_axis_size(name: str) -> int | None:
    """Size of an axis of the active mesh, or None outside a mesh (or for
    an axis it lacks)."""
    mesh = active_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.size(mesh.mesh_dim_names.index(name))


def spec_placements(mesh: DeviceMesh, spec: P, ndim: int) -> tuple:
    """The ``DTensor`` placements of a tensor of ``ndim`` dims laid out
    by ``spec`` on ``mesh`` (every axis of the spec must be the mesh's).
    An axis of size 1 splits nothing: its placement is ``Replicate()``,
    so no value is ever partial over it and no collective runs over its
    one-rank groups (gloo crashed on such a collective of CUDA tensors,
    torch 2.11 on the H100)."""
    dt = _dt()
    names = tuple(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than a {ndim}-d tensor")
    out: list = [dt.Replicate()] * mesh.ndim
    used: set = set()
    for dim, part in enumerate(spec):
        idx = [names.index(a) for a in _axes(part)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes of one dim must be in the mesh's "
                             f"order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"{spec}: axis {names[i]} used twice")
            used.add(i)
            if mesh.size(i) > 1:
                out[i] = dt.Shard(dim)
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too (the
    transpose of a sharding constraint is the same constraint on the
    cotangent, as in JAX): a partial gradient arriving here is reduced
    here, by one all-reduce of the activation's size."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def maybe_shard(x, spec: P):
    """Lay ``x`` out by ``spec`` (its gradient too) when a mesh with the
    spec's axes is active and ``x`` is laid out on it; the identity
    otherwise (one device, or a spec naming an axis the mesh lacks)."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if not {a for part in spec for a in _axes(part)} <= set(
            mesh.mesh_dim_names):
        return x
    return _Constrain.apply(x, spec_placements(mesh, spec, x.ndim))


def shard_range(size: int, mesh: DeviceMesh, placements, dim: int
                ) -> tuple[int, int]:
    """The ``[lo, hi)`` of tensor dim ``dim`` (of length ``size``) that
    this rank holds under ``placements``: each mesh dim that shards
    ``dim`` cuts the current piece into ``torch.chunk``'s pieces."""
    coord = mesh.get_coordinate()
    lo, hi = 0, size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            c = -(-(hi - lo) // mesh.size(i))
            lo, hi = min(lo + coord[i] * c, hi), min(lo + (coord[i] + 1) * c,
                                                     hi)
    return lo, hi


def place(t: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """A ``DTensor`` over ``mesh`` from the WHOLE tensor ``t``, which every
    rank holds (on any device): each rank keeps its own piece, copied to
    the mesh's device; no collective."""
    local = _narrow_all(t, mesh, placements)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = local.to(dev, copy=True, memory_format=torch.contiguous_format)
    return _dt().DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=contiguous_stride(t.shape))


def _narrow_all(t: torch.Tensor, mesh: DeviceMesh, placements
                ) -> torch.Tensor:
    for dim in sorted({p.dim for p in placements if p.is_shard()}):
        lo, hi = shard_range(t.shape[dim], mesh, placements, dim)
        t = t.narrow(dim, lo, hi - lo)
    return t


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``).
    :meth:`place` lays a whole tensor out by it.  Not a tuple, so that a
    tree of shardings has the shardings as leaves."""

    mesh: DeviceMesh
    spec: P

    def placements(self, ndim: int) -> tuple:
        return spec_placements(self.mesh, self.spec, ndim)

    def place(self, t: torch.Tensor):
        """``t`` (whole, on every rank) laid out on the mesh: a ``DTensor``
        holding this rank's piece, on the mesh's device.  A 0-d tensor
        has no dim to shard and stays a plain tensor (every rank holds the
        same value), so step counters and learning rates never mix with
        ``DTensor`` arithmetic."""
        if t.ndim == 0:
            return t.to(self.mesh.device_type, copy=True)
        return place(t, self.mesh, self.placements(t.ndim))


def named_sharding(mesh: DeviceMesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    if isinstance(specs, (tuple, list)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    if specs is None:
        return None
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def specs_to_shardings(mesh: DeviceMesh, specs: Any) -> Any:
    """A tree of :class:`P` -> a tree of :class:`NamedSharding` on
    ``mesh``, dropping the axis names the mesh lacks (``pod`` on one pod,
    ``model`` on a data-only mesh)."""
    names = set(mesh.mesh_dim_names)

    def fix(spec: P) -> NamedSharding:
        parts = []
        for part in spec:
            kept = tuple(a for a in _axes(part) if a in names)
            if isinstance(part, str) or part is None:
                parts.append(kept[0] if kept else None)
            else:
                parts.append(kept if kept else None)
        return NamedSharding(mesh, P(*parts))

    return _map_specs(fix, specs)


def replicate(x):
    """``x`` with every partial mesh dim reduced (one all-reduce of the
    tensor as it is); its shards stay shards.  The identity on a plain
    tensor."""
    if not is_dtensor(x):
        return x
    target = tuple(_dt().Replicate() if p.is_partial() else p
                   for p in x.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def to_local(x) -> torch.Tensor:
    """This rank's piece of ``x`` (``x`` itself if it is a plain tensor)."""
    return x.to_local() if is_dtensor(x) else x


def map_local(fn, x, *others):
    """``fn`` over this rank's pieces of ``x`` and ``others`` (laid out as
    ``x`` is; 0-d plain tensors pass as they are), each tensor it returns
    laid out as ``x`` again.  For elementwise work (an optimizer update, a
    clip) that needs no ``DTensor`` dispatch; plain tensors go straight
    to ``fn``."""
    if not is_dtensor(x):
        return fn(x, *others)
    for o in others:
        if is_dtensor(o) and (o.placements != x.placements
                                       or o.shape != x.shape):
            raise ValueError(f"map_local: {o.placements} {tuple(o.shape)} "
                             f"against {x.placements} {tuple(x.shape)}")
    out = fn(x.to_local(), *(to_local(o) for o in others))

    def wrap(t):
        return _dt().DTensor.from_local(t, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def embedding(table, ids):
    """``F.embedding(ids, table)``: rows of ``table [V, H]`` at the int
    ``ids`` (all in ``[0, V)``).

    For a ``DTensor`` table whose rows are sharded (``P("model", None)``),
    each rank looks up only the ids among the rows it holds, zeros the
    others, and returns its rows as a PARTIAL sum over the row-sharded mesh
    dims (no collective here; the caller's next :func:`replicate` or
    :func:`maybe_shard` reduces them).  The backward stays local too: each
    rank's gradient covers its own rows (partial over the mesh dims the ids
    are split on), never a table-sized tensor."""
    if not is_dtensor(table):
        return F.embedding(to_local(ids).long(), table)
    dt = _dt()
    mesh, tp = table.device_mesh, tuple(table.placements)
    if any(p.is_shard() and not p.is_shard(0) for p in tp):
        raise ValueError(f"embedding: table placements {tp}; only rows may "
                         f"be sharded")
    if is_dtensor(ids) and any(p.is_shard() and q.is_shard()
                               for p, q in zip(tp, ids.placements)):
        # ids split over a mesh dim that splits the rows too: every rank
        # of that dim needs all of its ids (one all-gather of the ids)
        ids = ids.redistribute(mesh, tuple(
            dt.Replicate() if p.is_shard() else q
            for p, q in zip(tp, ids.placements)))
    idp = (tuple(ids.placements) if is_dtensor(ids)
           else (dt.Replicate(),) * mesh.ndim)
    ids_local = to_local(ids).long()
    lo, hi = shard_range(table.shape[0], mesh, tp, 0)
    sharded = any(p.is_shard() for p in tp)
    out_pl, grad_pl = [], []
    for p, q in zip(tp, idp):
        if p.is_shard():
            out_pl.append(dt.Partial())
            grad_pl.append(dt.Shard(0))
        else:
            out_pl.append(q)
            grad_pl.append(dt.Partial() if q.is_shard() else dt.Replicate())
    local_table = table.to_local(grad_placements=grad_pl)
    if sharded:
        inside = (ids_local >= lo) & (ids_local < hi)
        rows = F.embedding(torch.where(inside, ids_local - lo, 0),
                           local_table) * inside[..., None].to(
                               local_table.dtype)
    else:
        rows = F.embedding(ids_local, local_table)
    shape = tuple(ids.shape) + (table.shape[1],)
    return dt.DTensor.from_local(rows, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def vocab_iota(logits):
    """``arange(V)`` over the last dim of ``logits`` (int64): for a
    ``DTensor`` whose last dim is sharded, each rank's piece holds its own
    global ids, laid out like that dim."""
    v = logits.shape[-1]
    if not is_dtensor(logits):
        return torch.arange(v, device=logits.device)
    dt = _dt()
    mesh, lp = logits.device_mesh, tuple(logits.placements)
    last = logits.ndim - 1
    pl = tuple(dt.Shard(0) if p.is_shard(last) else dt.Replicate()
               for p in lp)
    lo, hi = shard_range(v, mesh, lp, last)
    return dt.DTensor.from_local(
        torch.arange(lo, hi, device=logits.to_local().device), mesh, pl,
        run_check=False, shape=torch.Size((v,)), stride=(1,))


def logsumexp(logits, dim: int = -1, keepdim: bool = False):
    """``log(sum(exp(logits), dim))`` as the local max plus the log of the
    sum of ``exp(logits - max)``; over a sharded ``dim`` the max and the
    sum are each reduced by one all-reduce of the result's size.  The max
    is a constant to autograd, as in ``jax.nn.logsumexp``."""
    m = replicate(logits.detach().amax(dim, keepdim=True))
    s = replicate(torch.exp(logits - m).sum(dim, keepdim=True))
    out = m + torch.log(s)
    return out if keepdim else out.squeeze(dim)


def _collective_log_class():
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        """``CommDebugMode`` that also keeps each collective's op name,
        the shapes of its tensor inputs and output, and its output's
        bytes, in ``records`` (dicts ``op``, ``inputs``, ``output``,
        ``bytes``)."""

        def __enter__(self):
            self.records: list[dict] = []
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            name = str(func._overloadpacket)
            if name.startswith(("c10d", "_c10d_functional", "_dtensor")) \
                    and not name.endswith(("wait_tensor",
                                           "_wrap_tensor_autograd")):
                res = out[0] if isinstance(out, (list, tuple)) and out \
                    else out
                res = res if isinstance(res, torch.Tensor) else None
                self.records.append({
                    "op": name.split(".")[-1],
                    "inputs": [tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)],
                    "output": None if res is None else tuple(res.shape),
                    "bytes": 0 if res is None
                    else res.numel() * res.element_size()})
            return out

        def summary(self) -> dict:
            """``{op: [count, bytes]}`` over the records."""
            out: dict = {}
            for r in self.records:
                c = out.setdefault(r["op"], [0, 0])
                c[0] += 1
                c[1] += r["bytes"]
            return out

    return CollectiveLog


def __getattr__(name: str):
    # CollectiveLog subclasses CommDebugMode, which imports DTensor: the
    # class is made on first use
    if name == "CollectiveLog":
        cls = _collective_log_class()
        globals()[name] = cls
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
