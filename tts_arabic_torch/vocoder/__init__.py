"""Vocoders: HiFi-GAN generator and the spectral denoiser (Vocos in
`.vocos`)."""
from .denoiser import compute_bias_spec, denoise
from .hifigan import Generator, HiFiGANConfig, chunked_vocode

__all__ = ["Generator", "HiFiGANConfig", "chunked_vocode",
           "compute_bias_spec", "denoise"]
