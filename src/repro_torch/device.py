"""Device resolution: entry points run on the GPU unless asked for the CPU.

Also :class:`HostOutput`, which brings tensors to the host without a
device-wide wait: ``non_blocking`` copies into pinned host buffers and a
``torch.cuda.Event`` after them, which ``wait`` synchronises on — so a
thread waiting for one result does not also wait for the work queued
after it.  Its two halves are ``obs`` spans: ``output.copy`` (``pinned``:
the host buffers it pinned) and ``output.wait``.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["resolve_device", "HostOutput"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent.

    The card path starts here, so this is where fp32 matrix products and
    convolutions are pinned to full fp32: TF32 keeps ~3 decimal digits,
    which would break the parity tolerances against the JAX reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class HostOutput:
    """A pytree of tensors on its way to the host: on the card,
    ``non_blocking`` copies into pinned buffers and an event recorded
    after them on the current stream; on the CPU, the tensors as they
    are."""

    def __init__(self, out):
        self._event = None
        with obs.span("output.copy") as s:
            leaves = tree_leaves(out)
            on_card = leaves[0].device.type == "cuda"
            if on_card:
                out = tree_map(lambda t: torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True).copy_(
                        t, non_blocking=True), out)
                self._event = torch.cuda.Event()
                self._event.record()
            s.set(pinned=len(leaves) if on_card else 0)
        self._out = out

    def wait(self):
        """The tensors as numpy arrays, once this copy has landed."""
        with obs.span("output.wait"):
            if self._event is not None:
                self._event.synchronize()
            return tree_map(lambda t: t.numpy(), self._out)
