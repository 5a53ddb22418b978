"""Adam with the reference's TF-Keras hyperparameters (counterpart of
gan_tpu/train/optim.py).

``tf.keras.optimizers.Adam`` has epsilon 1e-7 and the update m̂ / (√v̂ + ε):
``torch.optim.Adam``'s form, and optax's with ``eps_root=0``. CycleGAN keeps
one optimizer per network.
"""

from __future__ import annotations

import torch

TF_ADAM_EPS = 1e-7  # tf.keras.optimizers.Adam default


def adam(params, learning_rate: float, beta_1: float = 0.5,
         beta_2: float = 0.999) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta_1, beta_2), eps=TF_ADAM_EPS)
