"""Example models around the quantizers, the FVQ bridge, and the example
trainers' data pipeline (`image_batches`; the native IDX loader in
`native_data`, built by `native_build`)."""

from .autoencoder import ConvDecoder, ConvEncoder, SimpleQuantizeAutoEncoder
from .data import image_batches
from .transformer import EncoderBlock, MiniEncoder
