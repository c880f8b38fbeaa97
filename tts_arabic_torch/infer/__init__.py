"""Inference API: the FastPitch + HiFi-GAN pipelines and long-form
synthesis."""
from .longform import split_sentences, stream_long, tts_long
from .pipeline import FastPitch2Wave, FastPitchTTS

__all__ = ["FastPitch2Wave", "FastPitchTTS", "split_sentences",
           "stream_long", "tts_long"]
