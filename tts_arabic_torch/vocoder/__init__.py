"""Vocoders: HiFi-GAN generator, its training discriminators and the
spectral denoiser (Vocos in `.vocos`)."""
from .denoiser import compute_bias_spec, denoise
from .discriminators import (MultiPeriodDiscriminator,
                             MultiScaleDiscriminator)
from .hifigan import Generator, HiFiGANConfig, chunked_vocode

__all__ = ["Generator", "HiFiGANConfig", "MultiPeriodDiscriminator",
           "MultiScaleDiscriminator", "chunked_vocode", "compute_bias_spec",
           "denoise"]
