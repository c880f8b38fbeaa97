"""Acoustic models: FastPitch (inference), weight carry-over."""
from .fastpitch import FastPitch, FastPitchConfig, regulate_len

__all__ = ["FastPitch", "FastPitchConfig", "regulate_len"]
