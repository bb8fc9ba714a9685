from vocoder_tpu_torch.losses.gan_loss import (  # noqa: F401
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from vocoder_tpu_torch.losses.stft_loss import multi_resolution_stft_loss  # noqa: F401
