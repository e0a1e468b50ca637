"""Data layer of the port: id indexing (BiMap) and storage."""

from predictionio_tpu_torch.data.bimap import BiMap

__all__ = ["BiMap"]
