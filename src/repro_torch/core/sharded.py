"""Vocab-sharded LSS: the distributed serving form of the paper's index
(counterpart of ``repro.core.sharded``).

Each shard owns m/TP contiguous WOL neurons and builds an independent LSS
index over them (theta is replicated — hyperplanes are tiny).  Per query:

    shard-local retrieve -> local sparse logits -> local top-k
    -> all-gather k candidates per shard (O(TP*k) per query, NOT O(m))
    -> global top-k

The JAX package runs this as one ``shard_map`` body.  Here it is two
parts, so that a serving step can capture the first as a CUDA graph and
run the second after the replay (``serve.step``):

* the **local part** (:func:`local_part`): ``lss_forward`` on each shard
  this rank holds (the fused ``lss_topk`` kernel on the card), ids made
  global at ``shard * m_local`` offsets, the per-shard candidates side by
  side in shard order, and the local sample size;
* the **merge**: an ``all_gather`` of the ``[B, k]`` candidates over the
  process group, then a pure top-k over ``[B, S*k]`` with ties to the
  lowest position (:func:`topk_merge`, as ``jax.lax.top_k``), and a sum
  of the sample sizes.  :func:`hierarchical_topk_merge` is the two-stage
  form for a (host, model) mesh.

A rank holds ``mesh.shards_per_rank`` shards (one on a fleet); a mesh
with no process group is one process holding them all, which is the
in-process oracle the fleets are held against.  On gloo the merge runs
on host copies of the candidates, on NCCL on the current stream.

A stack is a list of per-shard :class:`LSSIndex` (the JAX package stacks
the leaves along a leading ``[n_shards]`` axis and lets ``shard_map``
hand each device its slice); ``w_stack`` is ``[n_local, m_local, d]`` or
None.  Quantized slabs compose transparently: ``w_scale`` is per-shard
like the slabs.  The JAX ``make_sharded_predict``'s ``batch_axis`` has
no counterpart: the serving mesh has no batch axis, q is replicated.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.lss import LSSConfig, LSSIndex, build_index, lss_forward
from repro_torch.core.topk import topk_lowest_index

__all__ = ["LocalTopk", "build_local_index", "local_topk", "local_part",
           "topk_merge", "sharded_merge",
           "hierarchical_topk_merge", "multihost_merge",
           "sharded_lss_predict", "sharded_lss_forward",
           "multihost_lss_predict", "multihost_lss_forward",
           "make_sharded_predict", "make_multihost_predict"]


class LocalTopk(NamedTuple):
    """What a rank's shards hand the merge."""

    logits: torch.Tensor     # [B, n_local * k] top-k logits, shard order
    gids: torch.Tensor       # [B, n_local * k] GLOBAL ids, -1 = none
    sample: torch.Tensor     # [B] int32 unique neurons scored locally


def build_local_index(w_aug_local: torch.Tensor, theta: torch.Tensor,
                      cfg: LSSConfig) -> LSSIndex:
    """Build the index for one shard's rows.  Neuron ids inside are LOCAL
    row indices."""
    return build_index(w_aug_local, theta, cfg)


def local_topk(q: torch.Tensor, index: LSSIndex,
               w_aug_local: torch.Tensor | None, k: int,
               with_aux: bool = False, impl: str | None = None,
               dedup: str | None = None):
    """Shard-local Algorithm 2 returning exactly-k (logits, local ids).

    Delegates to ``lss_forward`` (the fused ``lss_topk`` on a bucket-major
    index), so shard-local slots fewer than k read -1 rather than an
    arbitrary duplicate id that would survive the global merge.  With
    ``with_aux`` also returns the per-query local sample size from the
    SAME retrieval pass.
    """
    out = lss_forward(q, index, w_aug_local, k, impl=impl, dedup=dedup)
    if with_aux:
        return out.top_logits, out.top_ids, out.sample_size
    return out.top_logits, out.top_ids


def local_part(q: torch.Tensor, index_stack: list[LSSIndex],
               w_stack: torch.Tensor | None, *, k: int, shard0: int,
               m_local: int, impl: str | None = None,
               dedup: str | None = None) -> LocalTopk:
    """Every local shard's top-k, ids global (``shard * m_local +
    local``, -1 kept), side by side in shard order from shard ``shard0``,
    with the summed local sample size."""
    logits, gids, sample = [], [], None
    for i, index in enumerate(index_stack):
        w = None if w_stack is None else w_stack[i]
        lg, ids, s = local_topk(q, index, w, k, with_aux=True, impl=impl,
                                dedup=dedup)
        logits.append(lg)
        gids.append(torch.where(ids >= 0, ids + (shard0 + i) * m_local,
                                torch.full_like(ids, -1)))
        sample = s if sample is None else sample + s
    return LocalTopk(torch.cat(logits, 1), torch.cat(gids, 1), sample)


def topk_merge(logits: torch.Tensor, gids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, S*k]`` candidates in shard order -> the global top-k, ties to
    the lowest position (``jax.lax.top_k`` + ``take_along_axis``)."""
    top, pos = topk_lowest_index(logits, k)
    return top, gids.gather(-1, pos)


def _all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, c]`` from every rank of ``group``, side by side in rank order
    (``jax.lax.all_gather(axis=1)`` reshaped to ``[B, size*c]``)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 1)


def _on_backend(local: LocalTopk, mesh) -> LocalTopk:
    """The candidates where the mesh's collectives take them: host copies
    on gloo, the tensors as they are otherwise."""
    if mesh.host_collectives and local.logits.device.type != "cpu":
        return LocalTopk(*(t.cpu() for t in local))
    return local


def _sum_sample(sample: torch.Tensor, group) -> torch.Tensor:
    sample = sample.clone()
    dist.all_reduce(sample, group=group)
    return sample


def sharded_merge(local: LocalTopk, k: int, mesh
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flat merge over every rank of ``mesh``: gather, top-k, and the
    global sample size (the sum over ranks).  Returns tensors on the
    local candidates' device."""
    dev = local.logits.device
    if mesh.group is None:
        top, ids = topk_merge(local.logits, local.gids, k)
        return top, ids, local.sample
    with mesh.lock:
        loc = _on_backend(local, mesh)
        top, ids = topk_merge(_all_gather_cols(loc.logits, mesh.group),
                              _all_gather_cols(loc.gids, mesh.group), k)
        sample = _sum_sample(loc.sample, mesh.group)
    return top.to(dev), ids.to(dev), sample.to(dev)


def hierarchical_topk_merge(logits: torch.Tensor, gids: torch.Tensor,
                            k: int, *, mesh, gather=_all_gather_cols
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k merge for a (host, model) mesh.

    Stage 1 all-gathers the candidates of every rank of this host over
    ``mesh.host_group`` (the model axis) and reduces to k per host; stage
    2 all-gathers only those k per host over ``mesh.cross_group`` (the
    host axis), so cross-host traffic is O(n_hosts * k) per query —
    independent of both m and the per-host shard count.

    Bit-identical to the flat single-stage merge: the top-k is stable
    (ties resolve to the lowest position), shard blocks are
    host-contiguous in the gather order, and every sub-k shard slot
    carries (NEG_INF, -1), so any candidate the intra-host stage drops
    already had k better-or-equal-earlier candidates on its own host and
    could never enter the flat global top-k either.  With ``n_hosts ==
    1`` stage 2 is skipped and this IS the flat merge.  Takes and returns
    tensors where the mesh's collectives take them.

    ``gather(x, group)`` puts the ``[..., B, c]`` candidates of every rank
    of ``group`` (``mesh.host_group``, then ``mesh.cross_group``) side by
    side in rank order: the ``all_gather`` by default; a test that holds
    every rank's candidates in one process passes a reshape instead."""
    host_logits, host_ids = topk_merge(gather(logits, mesh.host_group),
                                       gather(gids, mesh.host_group), k)
    if mesh.n_hosts == 1:
        return host_logits, host_ids
    return topk_merge(gather(host_logits, mesh.cross_group),
                      gather(host_ids, mesh.cross_group), k)


def multihost_merge(local: LocalTopk, k: int, mesh
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`hierarchical_topk_merge` and the sample size summed over the
    whole fleet.  Returns tensors on the local candidates' device."""
    dev = local.logits.device
    if mesh.group is None:
        return sharded_merge(local, k, mesh)
    with mesh.lock:
        loc = _on_backend(local, mesh)
        top, ids = hierarchical_topk_merge(loc.logits, loc.gids, k,
                                           mesh=mesh)
        sample = _sum_sample(loc.sample, mesh.group)
    return top.to(dev), ids.to(dev), sample.to(dev)


def _forward(merge, q, index_stack, w_stack, *, k, mesh, m_local,
             impl=None, dedup=None):
    if len(index_stack) != mesh.shards_per_rank:
        raise ValueError(f"{len(index_stack)} local shards for a mesh of "
                         f"{mesh.shards_per_rank} a rank")
    local = local_part(q, index_stack, w_stack, k=k,
                       shard0=mesh.shard_range()[0], m_local=m_local,
                       impl=impl, dedup=dedup)
    return merge(local, k, mesh)


def sharded_lss_forward(q: torch.Tensor, index_stack: list[LSSIndex],
                        w_stack: torch.Tensor | None, *, k: int, mesh,
                        m_local: int, impl: str | None = None,
                        dedup: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's shards, then the flat merge: global (top-k logits,
    top-k GLOBAL ids, sample size), the same on every rank."""
    return _forward(sharded_merge, q, index_stack, w_stack, k=k, mesh=mesh,
                    m_local=m_local, impl=impl, dedup=dedup)


def sharded_lss_predict(q, index_stack, w_stack, *, k: int, mesh,
                        m_local: int, impl: str | None = None,
                        dedup: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_lss_forward` without the sample size."""
    return sharded_lss_forward(q, index_stack, w_stack, k=k, mesh=mesh,
                               m_local=m_local, impl=impl,
                               dedup=dedup)[:2]


def multihost_lss_forward(q: torch.Tensor, index_stack: list[LSSIndex],
                          w_stack: torch.Tensor | None, *, k: int, mesh,
                          m_local: int, impl: str | None = None,
                          dedup: str | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`sharded_lss_forward` for a (host, model) mesh: the
    hierarchical merge, the sample size summed over both axes.  Global
    neuron id = (host * shards_per_host + shard in host) * m_local +
    local id."""
    return _forward(multihost_merge, q, index_stack, w_stack, k=k,
                    mesh=mesh, m_local=m_local, impl=impl, dedup=dedup)


def multihost_lss_predict(q, index_stack, w_stack, *, k: int, mesh,
                          m_local: int, impl: str | None = None,
                          dedup: str | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`multihost_lss_forward` without the sample size."""
    return multihost_lss_forward(q, index_stack, w_stack, k=k, mesh=mesh,
                                 m_local=m_local, impl=impl,
                                 dedup=dedup)[:2]


def make_sharded_predict(mesh, m_local: int, k: int,
                         with_aux: bool = False, impl: str | None = None,
                         dedup: str | None = None):
    """The sharded predictor over ``mesh`` (a ``distributed.ServingMesh``):
    a function ``(q, index_stack, w_stack=None) -> (logits [B,k], ids
    [B,k])`` — plus the sample size [B] if ``with_aux`` — where
    ``index_stack`` holds this rank's shards.  ``impl``/``dedup`` pin the
    shard-local ``lss_topk``.  The JAX function's axis name and config
    have no counterpart: the mesh's groups are what the merge uses."""
    body = sharded_lss_forward if with_aux else sharded_lss_predict
    return partial(_bind, body, k=k, mesh=mesh, m_local=m_local,
                   impl=impl, dedup=dedup)


def make_multihost_predict(mesh, m_local: int, k: int,
                           with_aux: bool = False, impl: str | None = None,
                           dedup: str | None = None):
    """:func:`make_sharded_predict` for a (host, model) mesh: each rank
    holds the shards of ``mesh.shard_range()`` (build them with
    ``serve.heads.shard_index(..., shard_range=...)`` so no rank holds
    another's rows); q and the outputs are replicated.  On a mesh of one
    host the merge is the flat one, bit for bit."""
    body = multihost_lss_forward if with_aux else multihost_lss_predict
    return partial(_bind, body, k=k, mesh=mesh, m_local=m_local,
                   impl=impl, dedup=dedup)


def _bind(body, q, index_stack, w_stack=None, **kw):
    return body(q, index_stack, w_stack, **kw)
