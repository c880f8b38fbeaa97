"""Inference API: the FastPitch + HiFi-GAN pipelines."""
from .pipeline import FastPitch2Wave, FastPitchTTS

__all__ = ["FastPitch2Wave", "FastPitchTTS"]
