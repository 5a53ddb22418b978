"""eager_idle_pct: the share of the traced stretch in which the card idled,
in gaps of at least ``trace.SHORT_GAP_US``, while the innermost program span
on the host was ``gan_tpu_torch.step.eager``: a step launched op by op (the
passes' partial tail batches, and a runner's warm-up), the card waiting on
the host's launches (``portbench.spans``)."""

from portbench import spans


def read(stretch):
    return spans.idle_pct(stretch, ("step.eager",))
