"""The data path of the port: the seekable synthetic stream and document
packing (counterpart of the JAX package's `repro.data`)."""

from .pipeline import DataPipeline, synthetic_batch
from .packing import pack_documents

__all__ = ["DataPipeline", "synthetic_batch", "pack_documents"]
