"""``copy_in_ms.<group>``: the median host ms of a serving step's copy-in
(``step.copy_in`` spans inside a ``rank`` span, begun in the window): a
fresh pinned buffer for each host input and its asynchronous copy into
the graph's static input."""

from wolbench.harness.spans import median_ms, under


def read(ctx):
    return median_ms(under(ctx, "step.copy_in", "rank"))
