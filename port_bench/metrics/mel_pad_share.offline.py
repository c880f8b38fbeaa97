"""The share of the decoded mel frames that no utterance keeps: 100 x (1 -
the `frames_kept` of the window's `tts.collect` spans (the real rows'
own frames) / the `frames_decoded` of its `tts.decode` spans (rows x
mel bucket, pad rows included)). The decoder, the vocoder and the
denoiser all run on every decoded frame. Nothing to read where the
program records no such span."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = encode.window_spans(ctx) or ()
    kept = sum(s.counts.get("frames_kept", 0) for s in spans
               if s.name == "tts.collect")
    decoded = sum(s.counts.get("frames_decoded", 0) for s in spans
                  if s.name == "tts.decode")
    if not decoded:
        return None
    return 100.0 * (1.0 - kept / decoded)
