"""U-Net generator and PatchGAN discriminator as ``nn.Module``s."""

from gan_tpu_torch.models.patchgan import PatchGANDiscriminator
from gan_tpu_torch.models.unet import UNetGenerator

__all__ = ["PatchGANDiscriminator", "UNetGenerator"]
