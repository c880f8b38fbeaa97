"""Evaluation: DTW alignment, oversmoothing metrics, MCD, attention-
alignment diagnostics, FLOP counts (`eval.flops`), plotting
(`eval.plotting`, matplotlib imported at first use) and gate-controlled
synthetic Tacotron2 checkpoints (`eval.gate_control`)."""
from .alignment import (alignment_diagnostics, diagonal_band_mass,
                        peak_drift, token_coverage)
from .dtw import dtw_align_mels, dtw_path, using_native_kernel
from .gate_control import install_gate_control
from .oversmoothing import (aligned_mae_distance,
                            compute_mel_oversmoothing_metrics,
                            framewise_rfft_power, mcd,
                            oversmoothing_metrics_aligned)

__all__ = [
    "dtw_align_mels", "dtw_path", "using_native_kernel",
    "aligned_mae_distance", "compute_mel_oversmoothing_metrics",
    "framewise_rfft_power", "mcd", "oversmoothing_metrics_aligned",
    "alignment_diagnostics", "diagonal_band_mass", "peak_drift",
    "token_coverage", "install_gate_control",
]
