"""The port's command-line tools: ``python -m gan_tpu_torch.tools.<name>``."""
