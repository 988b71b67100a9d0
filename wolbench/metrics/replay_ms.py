"""``replay_ms.<group>``: the median host ms of a serving step's CUDA
graph launch (``step.replay`` spans inside a ``rank`` span, begun in the
window)."""

from wolbench.harness.spans import median_ms, under


def read(ctx):
    return median_ms(under(ctx, "step.replay", "rank"))
