"""Trainers and checkpoints: the Pix2Pix and CycleGAN trainers (``fit``, the
train step, ``generate_batched`` for predict), their shared base, the
epoch plans, Adam, and the torch checkpoint manager."""
