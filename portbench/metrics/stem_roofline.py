"""stem_roofline: the stem conv + LeakyReLU kernel S
(``gan_tpu_torch/csrc/stem_conv.cu``), as the share of its bound: every
stem operation of the traced stretch (``portbench.counts.stem_ops``) over
the summed time of the kernels named below."""

from portbench import counts, trace

PATTERNS = ("stem_conv_kernel", "stem_conv_mma_kernel")


def read(stretch):
    return trace.roofline_pct(stretch, PATTERNS, counts.stem_ops)
