"""conv_device_pct: the share of the traced stretch's summed device time
spent in cuDNN's convolution and transposed-convolution kernels and their
layout kernels (the "convs" group of ``portbench.trace.GROUPS``, after the
port's own kernels, batch norm, Adam, copies and cat have taken theirs)."""

from portbench import trace


def read(stretch):
    total = sum(dur for _name, _ts, dur in stretch.device)
    if total <= 0:
        return None
    convs = sum(dur for name, _ts, dur in stretch.device if trace.group(name) == "convs")
    return 100.0 * convs / total
