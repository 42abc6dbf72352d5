from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec, CodecOutput
from contextual_image_compression_tpu_torch.models.autoencoder import Autoencoder
from contextual_image_compression_tpu_torch.models.discriminator import Discriminator
from contextual_image_compression_tpu_torch.models.encoder import Encoder
from contextual_image_compression_tpu_torch.models.generator import Generator
from contextual_image_compression_tpu_torch.models.latent_saliency import LatentSaliency
from contextual_image_compression_tpu_torch.models.rd_optimizer import RDOptimizer
from contextual_image_compression_tpu_torch.models.vgg import VGG19Features

__all__ = [
    "AdaptiveCodec",
    "Autoencoder",
    "CodecOutput",
    "Discriminator",
    "Encoder",
    "Generator",
    "LatentSaliency",
    "RDOptimizer",
    "VGG19Features",
]
