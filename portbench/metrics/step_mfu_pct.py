"""step_mfu_pct: the model FLOPs of the window's train steps
(``portbench.counts.step_flops``: 2 · MAC of every conv and transposed conv,
forward, dgrad where needed, wgrad; no recomputation) over the seconds of
the window's untraced epochs times the chip's dense peak for the
configuration's compute dtype (989 TFLOP/s in bf16 on an H100 SXM)."""

from portbench import counts


def read(stretch):
    w = stretch.window
    if w.get("seconds", 0) <= 0:
        return None
    return 100.0 * w["train_flops"] / (w["seconds"] * counts.PEAK_FLOPS[stretch.config["dtype"]])
