"""``prefill_forward_ms.<group>``: the median host ms of a prompt's eager
forward (``prefill.forward`` spans begun in the window), without the KV
join and the first token's head."""

from wolbench.harness.spans import began, median_ms


def read(ctx):
    return median_ms(began(ctx, "prefill.forward"))
