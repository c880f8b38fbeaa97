"""The benchmark's plain reference: straightforward float32 PyTorch of the
published models, with no kernel, cache, graph or batching, and nothing
imported from the program. It reads the same state dict (the published
layout) that the benchmark hands the program, and works out everything
else itself: tokens, durations, mels, waves and the denoiser's bias.
"""
