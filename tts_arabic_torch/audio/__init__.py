"""Audio/DSP layer: framing, STFT/ISTFT, the device log-mel, wav and
mu-law output."""
from .io import (load_wav, mulaw_decode, mulaw_encode, peak_normalize,
                 save_wav, trim_silence_db)
from .mel import (MelSpectrogram, frame_signal, log_mel_spectrogram,
                  mel_spectrogram, stft_magnitude)
from .stft import hann, istft, stft

__all__ = ["MelSpectrogram", "frame_signal", "hann", "istft", "load_wav",
           "log_mel_spectrogram", "mel_spectrogram", "mulaw_decode",
           "mulaw_encode", "peak_normalize", "save_wav", "stft",
           "stft_magnitude", "trim_silence_db"]
