"""The denoisers: the attention UNet and the toy conditional MLP."""

from physicsinformeddiffusionmodels_tpu_torch.models.blocks import SignalEmbedding
from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet

__all__ = ["ConditionalModel", "SignalEmbedding", "UNet"]
