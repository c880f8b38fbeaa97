"""The text frontend's host time per utterance in the Tacotron2 cell: the
host us of the window's `tts.frontend` spans over the utterances they
counted (`frontend_us_per_utt.offline`'s arithmetic). Nothing to read
where the program records no such span."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin(
        "metrics", "frontend_us_per_utt.offline").read(ctx)
