"""Example models around the quantizers, and the FVQ bridge."""

from .autoencoder import ConvDecoder, ConvEncoder, SimpleQuantizeAutoEncoder
from .transformer import EncoderBlock, MiniEncoder
