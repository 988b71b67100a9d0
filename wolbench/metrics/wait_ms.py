"""``wait_ms.<group>``: the median host ms of ``HostOutput.wait``
(``output.wait`` spans begun in the window): the host waiting on the
card for an answer's copy home, then viewing it as numpy."""

from wolbench.harness.spans import began, median_ms


def read(ctx):
    return median_ms(began(ctx, "output.wait"))
