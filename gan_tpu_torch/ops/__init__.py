"""Compute primitives: TF-'same' convs (cuDNN through torch), instance norm
(plain PyTorch) and the hand-written CUDA kernels that replace gan_tpu's
Pallas kernels (``kernels``, built by ``build``)."""
