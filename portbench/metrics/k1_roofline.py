"""k1_roofline: the instance norm's forward kernel K1
(``gan_tpu_torch/csrc/instance_norm.cu``), as the share of its bound: every
forward instance norm of the traced stretch (``portbench.counts.norm_ops``)
over the summed time of the kernels named below."""

from portbench import counts, trace

PATTERNS = ("instance_norm_fwd_kernel",)


def read(stretch):
    return trace.roofline_pct(
        stretch, PATTERNS, lambda c, training, bx, by: counts.norm_ops(c, training, bx, by, False))
