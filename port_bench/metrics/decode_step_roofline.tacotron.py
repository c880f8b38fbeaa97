"""The Tacotron2 decode's share of its roofline: over the window's
`tts.decode` spans, the least time of one decode step at the span's batch
shape (its counts `rows` and `text_len`; the frozen `yardstick_tacotron2.
decode_step_bound_s` in the configuration's dtype) times the steps it ran
(`decode_steps`), summed, over the spans' device time (CUDA events around
the blocks and the postnet, the waits for their own dispatch included).
Nothing to read where the program records no such span, count or device
time."""
from port_bench import harness, yardstick_tacotron2


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = [s for s in encode.window_spans(ctx) or ()
             if s.name == "tts.decode"]
    if not spans or any(s.device_ms is None or "decode_steps" not in s.counts
                        for s in spans):
        return None
    cfg = ctx.program.config["tacotron2"]
    bound_s = sum(s.counts["decode_steps"]
                  * yardstick_tacotron2.decode_step_bound_s(
                      cfg, s.counts["rows"], s.counts["text_len"],
                      ctx.program.dtype) for s in spans)
    device_s = 1e-3 * sum(s.device_ms for s in spans)
    return 100.0 * bound_s / device_s if device_s > 0 else None
