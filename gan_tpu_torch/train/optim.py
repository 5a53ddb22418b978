"""Adam with the reference's TF-Keras hyperparameters (counterpart of
gan_tpu/train/optim.py).

``tf.keras.optimizers.Adam`` has epsilon 1e-7 and the update m̂ / (√v̂ + ε):
``torch.optim.Adam``'s form, and optax's with ``eps_root=0``. CycleGAN keeps
one optimizer per network.

On the card the update is not this optimizer's ``step`` but the kernel of
``csrc/adam.cu`` (``ops.kernels.adam_step``), which reads and writes its
state. ``capturable`` keeps the step counts on the device, where the kernel
advances them and where ``load_state_dict`` puts them (the CPU does not
take it).
"""

from __future__ import annotations

import torch

TF_ADAM_EPS = 1e-7  # tf.keras.optimizers.Adam default


def adam(params, learning_rate: float, beta_1: float = 0.5, beta_2: float = 0.999, *,
         eps: float = TF_ADAM_EPS, capturable: bool = False) -> torch.optim.Adam:
    """``eps``: tf.keras' by default; pix2pixHD's trainer passes torch's 1e-8."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta_1, beta_2), eps=eps,
                            capturable=capturable)
