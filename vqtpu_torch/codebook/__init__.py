"""The codebook module and kmeans init. As in the JAX package,
`vqtpu_torch.codebook.kmeans` is the function; the module that holds it is
reached as `importlib.import_module('vqtpu_torch.codebook.kmeans')`."""

from .codebook import Codebook
from .kmeans import kmeans
