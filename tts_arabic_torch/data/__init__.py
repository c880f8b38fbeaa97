"""Training data on the host: FastPitch datasets, dynamic batching, collate,
and the pYIN f0 estimator."""
from .dataset import (ArabDataset, ArabDatasetFastPitch, DynBatchDataset,
                      collate_fastpitch, normalize_pitch, parse_label_line,
                      silence_keep_mask)
from .f0 import estimate_f0, extract_f0_dict

__all__ = ["ArabDataset", "ArabDatasetFastPitch", "DynBatchDataset",
           "collate_fastpitch", "estimate_f0", "extract_f0_dict",
           "normalize_pitch", "parse_label_line", "silence_keep_mask"]
