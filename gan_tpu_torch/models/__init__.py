"""U-Net generator as ``nn.Module``s (PatchGAN comes with training)."""

from gan_tpu_torch.models.unet import UNetGenerator

__all__ = ["UNetGenerator"]
