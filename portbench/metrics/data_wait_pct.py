"""data_wait_pct: the share of the traced stretch that the main thread spent
waiting for streamed batches: the summed ``gan_tpu_torch.data.wait`` spans
(its ``next()`` on ``prefetch_iter``'s queue) over the stretch's span."""

from portbench import spans


def read(stretch):
    wait = spans.name("data.wait")
    if wait is None:
        return None
    waits = [(a, b) for a, b, n in spans.program(stretch) if n == wait]
    if not waits:
        return None
    return 100.0 * sum(b - a for a, b in waits) / (stretch.end - stretch.start)
