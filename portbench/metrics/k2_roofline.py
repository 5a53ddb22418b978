"""k2_roofline: the instance norm's backward kernel K2
(``gan_tpu_torch/csrc/instance_norm.cu``), as the share of its bound: every
instance-norm backward that the traced stretch's train steps need
(``portbench.counts.norm_ops``) over the summed time of the kernels named
below."""

from portbench import counts, trace

PATTERNS = ("instance_norm_bwd_kernel",)


def read(stretch):
    return trace.roofline_pct(
        stretch, PATTERNS, lambda c, training, bx, by: counts.norm_ops(c, training, bx, by, True))
