"""Audio/DSP layer: framing, STFT/ISTFT, wav and mu-law output."""
from .io import mulaw_decode, mulaw_encode, peak_normalize, save_wav
from .mel import frame_signal
from .stft import hann, istft, stft

__all__ = ["frame_signal", "hann", "istft", "mulaw_decode", "mulaw_encode",
           "peak_normalize", "save_wav", "stft"]
