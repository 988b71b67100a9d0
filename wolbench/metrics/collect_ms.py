"""``collect_ms.<group>``: the median host ms of the decode scheduler's
collect (``tick.collect`` spans begun in the window): the wait for the
previous step's ids on the card, then each stream's token."""

from wolbench.harness.spans import began, median_ms


def read(ctx):
    return median_ms(began(ctx, "tick.collect"))
