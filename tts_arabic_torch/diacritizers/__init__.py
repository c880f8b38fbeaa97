"""Diacritizers (vowelizers): unvocalized Arabic -> vowelized Arabic.

Shakkala (hard-sigmoid-gate BiLSTM stack) and Shakkelha (standard BiLSTM
stack), the port's counterparts of the JAX package's `diacritizers/`. The
character vocabularies are JSON data files (`vocab_*.json`, copies of the
JAX package's) because they index the pretrained checkpoints'
embeddings.
"""
from .models import Shakkala, Shakkelha, hard_sigmoid, load_vowelizer

__all__ = ["Shakkala", "Shakkelha", "hard_sigmoid", "load_vowelizer"]
