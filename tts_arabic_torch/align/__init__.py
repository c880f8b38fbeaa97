"""Alignment for training: monotonic alignment search (plain version of the
MAS kernel) and the beta-binomial attention prior."""
from .mas import mas, mas_durations
from .prior import BetaBinomialInterpolator, beta_binomial_prior

__all__ = ["BetaBinomialInterpolator", "beta_binomial_prior", "mas",
           "mas_durations"]
