"""A profiled window: ``torch.profiler`` over the host (every thread) and,
on the card, the device; its raw records reduced by
``wolbench.cost.breakdown``."""

from __future__ import annotations

import time

import torch

from wolbench.cost.breakdown import reduce_window

__all__ = ["Profiled", "device_window"]


class Profiled:
    """``with Profiled(on, device) as p: ...``; afterwards ``p.t0``,
    ``p.t1`` (host clock) and ``p.window`` (the reduction), or None when
    off."""

    def __init__(self, on: bool, device: torch.device):
        if on:
            # starting the profiler imports torch.distributed.tensor; on
            # another thread the program's DTensor check would read it half
            # made, so it is imported here, before the load starts
            import torch.distributed.tensor  # noqa: F401
            import torch.profiler  # noqa: F401
        self.on = on
        self.device = device
        self.window = None
        self.t0 = self.t1 = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        """End the profiled window (the run's window may go on)."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.stop()

    def reduce(self) -> dict | None:
        """The window's breakdown (after ``stop``)."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType
        recs = []
        for e in self._prof.profiler.kineto_results.events():
            on_dev = e.device_type() == DeviceType.CUDA
            if on_dev and e.is_user_annotation():
                continue                    # ranges mirrored from the host
            t0 = e.start_ns()
            recs.append((on_dev, e.name(), t0, t0 + e.duration_ns(),
                         e.start_thread_id()))
        self._prof = None
        self.window = reduce_window(recs)
        return self.window


def device_window(ctx) -> dict | None:
    """A run's profiled window reduced, or None where nothing ran on the
    device (a run on the CPU, or no profile)."""
    w = ctx.prof.window if ctx.prof is not None else None
    return w if w and w["busy_s"] > 0 and w["window_s"] > 0 else None
