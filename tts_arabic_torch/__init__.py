"""PyTorch/CUDA port of tts_arabic_tpu, for one NVIDIA H100 (Hopper).

Mirrors the JAX package's sub-package paths (`text/`, `audio/`, `models/`,
`vocoder/`, `ops/`, `infer/`) and keeps its [B, T, C] layout at public
functions. Imports torch, numpy and the standard library only: never jax,
flax or the JAX package. Entry points run on the card unless the caller
passes `device="cpu"`. The HiFi-GAN ResBlock1 runs as a hand-written CUDA
kernel (`ops/resblock.py`, `csrc/resblock1.cu`) on CUDA tensors.
"""
