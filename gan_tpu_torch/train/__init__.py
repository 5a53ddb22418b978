"""Trainers and checkpoints. This slice holds the CycleGAN generators and
their predict path; training is not ported yet."""
