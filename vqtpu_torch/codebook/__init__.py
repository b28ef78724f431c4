"""The codebook module."""

from .codebook import Codebook
