"""The share of the decode's row-steps that no utterance keeps: 100 x (1 -
the `frames_kept` of the window's `tts.collect` spans (the real rows' own
frames) / the `rows` x `decode_steps` of its `tts.decode` spans). A batch
decodes until its longest row stops (and to the end of that block), every
row at every step, so rows that have stopped and pad rows cost as much as
live ones. Nothing to read where the program records no such span or
count."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = encode.window_spans(ctx) or ()
    kept = sum(s.counts.get("frames_kept", 0) for s in spans
               if s.name == "tts.collect")
    decoded = sum(s.counts.get("rows", 0) * s.counts.get("decode_steps", 0)
                  for s in spans if s.name == "tts.decode")
    if not decoded:
        return None
    return 100.0 * (1.0 - kept / decoded)
