"""``dispatch_ms.<group>``: the median host ms of the decode scheduler's
dispatch (``tick.dispatch`` spans begun in the window): the fused step's
copy-in, replay and clone, its ids' copy home started, the pool's
lengths advanced."""

from wolbench.harness.spans import began, median_ms


def read(ctx):
    return median_ms(began(ctx, "tick.dispatch"))
