"""Example models around the quantizers."""

from .autoencoder import ConvDecoder, ConvEncoder, SimpleQuantizeAutoEncoder
