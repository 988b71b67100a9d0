"""Roofline terms of a traced cell on H100s (counterpart of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, per device:

  compute    = sum over dtypes of flops / that dtype's peak
               (BF16/FP16 products at the dense BF16 tensor-core peak,
               everything else at the FP32 peak: the port runs fp32 with
               TF32 off)
  memory     = bytes / HBM bandwidth
  collective = per-device collective traffic / link bandwidth
               (NVLink where every rank of the op's group sits in one node
               of 8, the network between nodes otherwise)

The counts come from the dry-run's trace (``repro_torch.launch.dryrun``),
not from a compiled program's cost analysis as in the JAX package; the
collectives are the ``c10d`` ops the trace recorded, each with its group.
Per op, JAX's ring accounting (``s`` the op's per-device result bytes,
``g`` the group's size):

  all-reduce      2 * s * (g-1)/g      (reduce-scatter + all-gather)
  all-gather      s * (g-1)/g          (receives everyone else's shard)
  reduce-scatter  s * (g-1)            (sends/combines g-1 shards)
  all-to-all      s * (g-1)/g
  collective-permute  s

The constants are the H100 SXM5 datasheet's (``repro_torch.launch.mesh``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, NETWORK_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32)

__all__ = ["CollectiveStats", "Roofline", "ring_traffic", "link_of",
           "peak_flops", "collective_stats", "roofline_from_terms"]

# dtypes whose products run at the BF16 tensor-core peak
_TENSOR_CORE = ("bfloat16", "float16")


class CollectiveStats(NamedTuple):
    bytes_by_op: dict[str, float]    # per-device traffic, ring-accounted
    count_by_op: dict[str, int]
    # per-device traffic by link: {"nvlink": bytes, "network": bytes}
    bytes_by_link: dict[str, float] = {}

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def ring_traffic(op: str, size: float, g: int) -> float:
    """Per-device bytes of one collective ``op`` whose per-device result is
    ``size`` bytes over a group of ``g`` ranks (JAX's accounting)."""
    g = max(int(g), 1)
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op in ("all-gather", "all-to-all"):
        return size * (g - 1) / g
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {op!r}")


def link_of(ranks) -> str:
    """``nvlink`` where every rank of the group is in one node of
    :data:`GPUS_PER_NODE` (ranks laid out node by node), else
    ``network``."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


def collective_stats(records) -> CollectiveStats:
    """Ring-accounted traffic of recorded collectives: ``records`` are
    ``(op, per-device result bytes, group ranks)``."""
    by_op: dict[str, float] = {}
    count: dict[str, int] = {}
    by_link: dict[str, float] = {}
    for op, size, ranks in records:
        t = ring_traffic(op, size, len(ranks))
        by_op[op] = by_op.get(op, 0.0) + t
        count[op] = count.get(op, 0) + 1
        link = link_of(ranks)
        by_link[link] = by_link.get(link, 0.0) + t
    return CollectiveStats(by_op, count, by_link)


def peak_flops(dtype: str) -> float:
    """The H100's peak for products in ``dtype`` (a torch dtype's name)."""
    return PEAK_FLOPS_BF16 if dtype in _TENSOR_CORE else PEAK_FLOPS_FP32


class Roofline(NamedTuple):
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (traced flops * devices)

    def as_dict(self) -> dict:
        return self._asdict()


def roofline_from_terms(by_dtype: Mapping[str, float], bts: float,
                        by_link: Mapping[str, float],
                        n_devices: int, model_flops: float) -> Roofline:
    """Per-device (flops, bytes, collective bytes) -> roofline terms:
    ``by_dtype`` is ``{dtype name: flops}``, ``by_link`` ``{"nvlink":
    bytes, "network": bytes}``."""
    total_flops_dev = sum(by_dtype.values())
    t_c = sum(f / peak_flops(dt) for dt, f in by_dtype.items())
    t_m = bts / HBM_BW
    t_x = (by_link.get("nvlink", 0.0) / NVLINK_BW
           + by_link.get("network", 0.0) / NETWORK_BW)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_flops = total_flops_dev * n_devices
    return Roofline(total_flops_dev, bts, sum(by_link.values()), t_c, t_m,
                    t_x, bottleneck, model_flops,
                    model_flops / total_flops if total_flops else 0.0)
