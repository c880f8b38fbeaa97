"""The text frontend's host time per utterance: the host us of the
window's `tts.frontend` spans (tokenizing each batch) over the
utterances they counted. Nothing to read where the program records no
such span."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = [s for s in encode.window_spans(ctx) or ()
             if s.name == "tts.frontend"]
    utterances = sum(s.counts.get("utterances", 0) for s in spans)
    if not utterances:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in spans) / utterances
