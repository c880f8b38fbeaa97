"""The share of the frames HiFi-GAN vocodes that no utterance keeps: 100 x
(1 - the `frames_kept` of the window's `tts.collect` spans (the real rows'
own frames) / the `frames_vocoded` of its `tts.vocode` spans (rows x
frames of every generator call)). Nothing to read where the program
records no such span or count."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = encode.window_spans(ctx) or ()
    kept = sum(s.counts.get("frames_kept", 0) for s in spans
               if s.name == "tts.collect")
    vocoded = sum(s.counts.get("frames_vocoded", 0) for s in spans
                  if s.name == "tts.vocode")
    if not vocoded:
        return None
    return 100.0 * (1.0 - kept / vocoded)
