"""Long-form synthesis: paragraphs/documents -> one waveform (the port's
copy of the JAX package's `infer/longform.py`).

The reference API (and ours, for parity) synthesizes utterances; real
serving inputs are paragraphs. This module splits text on sentence
punctuation (Arabic ؟ ؛ ۔ and Latin . ! ? ;), synthesizes the sentences
as ONE batched call (bucketed, length-sorted — the framework's cheapest
path), and joins them with a configurable pause. Splitting also strips
the terminal punctuation, which shields users from the tokenizer's
shared-with-the-reference quirk (trailing '.' raises KeyError in
`tokens_to_ids` — reference `text/__init__.py` behaves identically).

Works with any pipeline exposing `.tts`/`.stream`/`.sample_rate`
(FastPitch2Wave, Tacotron2Wave).
"""
from __future__ import annotations

import re
from typing import Iterator, List

import numpy as np

# sentence terminators: Latin . ! ? ; and Arabic ؟ ؛ ۔ (plus ellipsis runs)
_SENT_END = re.compile(r"[.!?;؟؛۔]+[\s]*")


def split_sentences(text: str) -> List[str]:
    """Split a paragraph into sentences, stripping terminal punctuation
    and surrounding whitespace; empty segments are dropped."""
    parts = _SENT_END.split(text)
    return [p.strip() for p in parts if p.strip()]


def tts_long(pipe, text: str, pause_s: float = 0.25, batch_size: int = 16,
             **tts_kwargs) -> np.ndarray:
    """Synthesize a paragraph as one waveform: batched sentence synthesis
    + `pause_s` seconds of silence between sentences. Extra kwargs pass
    through to `pipe.tts` (speed/denoise/speaker_id/vowelizer/...).
    Returns float32 (or int16/uint8 when `out_int16` is set — the pause
    silence matches the output dtype)."""
    if tts_kwargs.get("return_mel"):
        raise ValueError("tts_long returns one joined waveform; "
                         "use pipe.tts(split_sentences(text), "
                         "return_mel=True) for per-sentence mels")
    sentences = split_sentences(text)
    if not sentences:
        return np.zeros(0, np.float32)
    waves = pipe.tts(sentences, batch_size=batch_size, **tts_kwargs)
    pause_n = int(round(pause_s * pipe.sample_rate))
    silence = np.zeros(pause_n, dtype=np.asarray(waves[0]).dtype)
    if str(silence.dtype) == "uint8":  # mu-law code for 0.0 is 128
        silence = silence + 128
    parts = []
    for i, w in enumerate(waves):
        parts.append(np.asarray(w))
        if i != len(waves) - 1 and pause_n:
            parts.append(silence)
    return np.concatenate(parts)


def stream_long(pipe, text: str, pause_s: float = 0.25,
                **stream_kwargs) -> Iterator[np.ndarray]:
    """Stream a paragraph: sentences stream back-to-back (each via
    `pipe.stream`, so first audio arrives after one chunk of the FIRST
    sentence), with a silence chunk between sentences."""
    sentences = split_sentences(text)
    pause_n = int(round(pause_s * pipe.sample_rate))
    for i, sent in enumerate(sentences):
        chunk = None
        for chunk in pipe.stream(sent, **stream_kwargs):
            yield chunk
        if i != len(sentences) - 1 and pause_n and chunk is not None:
            silence = np.zeros(pause_n, dtype=np.asarray(chunk).dtype)
            if str(silence.dtype) == "uint8":
                silence = silence + 128
            yield silence
