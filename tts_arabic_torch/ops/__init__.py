"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`resblock`: HiFi-GAN ResBlock1; `mas`: monotonic alignment
search), and the CTC loss of the aligner. Sources live in `../csrc/` and
are built at first use by `build`."""
from .mas import mas_fused
from .resblock import (LAUNCHES, reset_launches, resblock1,
                       resblock1_plain)

__all__ = ["LAUNCHES", "mas_fused", "reset_launches", "resblock1",
           "resblock1_plain"]
