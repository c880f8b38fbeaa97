"""The Tacotron2 encode's device time per second of audio completed: the
device ms of the window's `tts.encode` spans (the encoder convs, the
BiLSTM and the attention keys), in us, over the audio seconds the window
served (`encode_device_us_per_audio_s.offline`'s arithmetic). Nothing to
read where the program records no such span or no device time."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin(
        "metrics", "encode_device_us_per_audio_s.offline").read(ctx)
