"""gan_tpu_torch — the PyTorch / CUDA port of gan_tpu, for NVIDIA Hopper.

It sits beside ``gan_tpu`` (the JAX reference it is held against) and mirrors
its layout: ``ops`` (convs, instance norm and its CUDA kernel), ``models``,
``data``, ``train``, ``utils``, ``config`` and the ``cycle_gan`` CLI. It imports
torch and never jax, and nothing of ``gan_tpu``.

It runs CycleGAN ``--train`` and ``--predict``; Pix2Pix is not ported yet.
"""

__version__ = "0.1.0"
