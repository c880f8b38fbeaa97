"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`resblock`: HiFi-GAN ResBlock1). Sources live in `../csrc/` and
are built at first use by `build`."""
from .resblock import (LAUNCHES, reset_launches, resblock1,
                       resblock1_plain)

__all__ = ["LAUNCHES", "reset_launches", "resblock1", "resblock1_plain"]
