"""Training data on the host: FastPitch and Tacotron2 datasets, dynamic
batching, collate, balanced sampling, and the pYIN f0 estimator."""
from .dataset import (ArabDataset, ArabDatasetFastPitch, DynBatchDataset,
                      WeightedSampler, collate_fastpitch, collate_tacotron,
                      normalize_pitch, parse_label_line, silence_keep_mask)
from .f0 import estimate_f0, extract_f0_dict

__all__ = ["ArabDataset", "ArabDatasetFastPitch", "DynBatchDataset",
           "WeightedSampler", "collate_fastpitch", "collate_tacotron",
           "estimate_f0", "extract_f0_dict", "normalize_pitch",
           "parse_label_line", "silence_keep_mask"]
