"""The denoiser's device time per second of audio completed, in the
Tacotron2 cell: the device ms of the window's `tts.denoise` spans, in us,
over the audio seconds the window served
(`denoise_device_us_per_audio_s.offline`'s arithmetic). Nothing to read
where the program records no such span or no device time."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin(
        "metrics", "denoise_device_us_per_audio_s.offline").read(ctx)
