"""pad_device_pct: the share of the traced stretch's summed device time
spent in ATen's reflection-pad kernels, forward and backward (names that
hold ``reflection_pad``): the residual generator's pads, whose backward
accumulates with atomics. None where the stretch ran none."""

PATTERN = "reflection_pad"


def read(stretch):
    total = sum(dur for _name, _ts, dur in stretch.device)
    pads = sum(dur for name, _ts, dur in stretch.device if PATTERN in name)
    if total <= 0 or pads <= 0:
        return None
    return 100.0 * pads / total
