"""The decode's device time per second of audio completed: the device ms
of the window's `tts.decode` spans (length regulation, the decoder and
the mel projection in the compute dtype), in us, over the audio seconds
the window served (the arithmetic of
`encode_device_us_per_audio_s.offline`, the waits for the stage's own
dispatch included). Nothing to read where the program records no such
span or no device time."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    return encode.stage_us_per_audio_s(ctx, "tts.decode")
