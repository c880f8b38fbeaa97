"""Inference API: the FastPitch and Tacotron2 pipelines with HiFi-GAN, and
long-form synthesis."""
from .longform import split_sentences, stream_long, tts_long
from .pipeline import FastPitch2Wave, FastPitchTTS
from .tacotron_pipeline import Tacotron2TTS, Tacotron2Wave

__all__ = ["FastPitch2Wave", "FastPitchTTS", "Tacotron2TTS", "Tacotron2Wave",
           "split_sentences", "stream_long", "tts_long"]
