"""The FastPitch encode's device time per second of audio completed: the
device ms of the window's `tts.encode` spans (CUDA events around each
batch's encode, `tts_arabic_torch.runtime.profiling`), in us, over the
audio seconds the window served. The events time the device from the
stage's first queued work to its last, so the waits for the stage's own
host dispatch are in it (most of the encode's). Nothing to read where
the program records no such span or no device time (off the card).

`stage_us_per_audio_s` is the other stages' readers' arithmetic too."""


def window_spans(ctx):
    """The program's spans inside the traced window, or None where the
    program records none."""
    try:
        from tts_arabic_torch.runtime import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    return recorded(round(ctx.trace.start * 1e9), round(ctx.trace.end * 1e9))


def audio_s(ctx) -> float:
    return sum(n for _, n in ctx.served) / ctx.program.sample_rate


def stage_us_per_audio_s(ctx, name: str):
    spans = window_spans(ctx)
    if not spans:
        return None
    ms = [s.device_ms for s in spans if s.name == name]
    if not ms or any(m is None for m in ms) or audio_s(ctx) <= 0:
        return None
    return 1e3 * sum(ms) / audio_s(ctx)


def read(ctx):
    return stage_us_per_audio_s(ctx, "tts.encode")
