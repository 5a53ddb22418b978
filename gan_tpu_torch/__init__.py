"""gan_tpu_torch — the PyTorch / CUDA port of gan_tpu, for NVIDIA Hopper.

It sits beside ``gan_tpu`` (the JAX reference it is held against) and mirrors
its layout: ``ops`` (convs, norms and the CUDA kernels' wrappers), ``models``,
``data``, ``train``, ``parallel`` (data parallelism on torch.distributed),
``utils``, ``config``, the ``pix2pix`` and ``cycle_gan`` CLIs, and ``quality``
with ``tools.eval_quality``. It imports torch and never
jax, and nothing of ``gan_tpu``.

It runs Pix2Pix and CycleGAN, ``--train`` and ``--predict``, and scores
generated images (L1, PSNR, SSIM, the Fréchet proxy, FID over
``models/inception.py``). Its CUDA kernels
are in ``csrc/``: the instance norm's forward and backward, and the fused
stem conv.
"""

__version__ = "0.1.0"
