"""HiFi-GAN's device time per second of audio completed: the device ms of
the window's `tts.vocode` spans (the generator, its MRF ResBlock kernels
included), in us, over the audio seconds the window served (the
arithmetic of `encode_device_us_per_audio_s.offline`). Nothing to read
where the program records no such span or no device time."""
from port_bench import harness


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    return encode.stage_us_per_audio_s(ctx, "tts.vocode")
