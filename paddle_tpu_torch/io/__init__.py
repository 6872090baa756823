"""Data input (port of ``paddle_tpu.io``): so far the packed-sequence
pretraining pipeline, ``packing``. The samplers and ``DataLoader`` are
PyTorch's own (``torch.utils.data``); ``PackedDataset`` is a map-style
``torch.utils.data.Dataset``."""
from . import packing
from .packing import (PAD_SEGMENT_ID, PackedBatch, PackedDataset,
                      pack_documents, packing_efficiency, pad_documents,
                      positions_from_segment_ids)

__all__ = ["packing", "PAD_SEGMENT_ID", "PackedBatch", "PackedDataset",
           "pack_documents", "packing_efficiency", "pad_documents",
           "positions_from_segment_ids"]
