"""``pinned_buffers.<group>``: the host buffers pinned a ``rank`` call:
the ``pinned`` counts of the ``step.copy_in`` and ``output.copy`` spans
begun in the window, over the ``rank`` spans begun there."""

from wolbench.harness.spans import began


def read(ctx):
    ranks = began(ctx, "rank")
    if not ranks:
        return None
    pinned = sum(s.args.get("pinned", 0)
                 for name in ("step.copy_in", "output.copy")
                 for s in began(ctx, name))
    return pinned / len(ranks)
