from .nets import (
    RSSM, MultiEncoder, MultiDecoder, ImageEncoderSimple, ImageDecoderSimple,
    ImageEncoderResnet, ImageDecoderResnet, MLP, DistLayer)
