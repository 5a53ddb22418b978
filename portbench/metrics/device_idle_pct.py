"""device_idle_pct: the share of the traced stretch (one whole epoch, train
then val) in which no kernel, copy or memset ran on the card."""


def read(stretch):
    if not stretch.device:
        return None
    return 100.0 * (1.0 - stretch.busy_us() / (stretch.end - stretch.start))
