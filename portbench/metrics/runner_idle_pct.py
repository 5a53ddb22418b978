"""runner_idle_pct: the share of the traced stretch in which the card idled,
in gaps of at least ``trace.SHORT_GAP_US``, while the innermost program span
on the host was the epoch runner's own code inside a pass: the pass outside
its children, its row plan and the rows' copy, its loss fetch, a step's
prepare, a replay's launch or a capture (``portbench.spans.RUNNER``)."""

from portbench import spans


def read(stretch):
    return spans.idle_pct(stretch, spans.RUNNER)
