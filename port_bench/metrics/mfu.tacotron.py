"""Model FLOPs utilization of the Tacotron2 cell's window
(`mfu.offline`'s arithmetic): the FLOPs of every utterance it completed, at
its own tokens and frames (the benchmark's frozen counts: Tacotron2's
decode at one step a frame, so the steps its batch ran past its stop are
not counted, and HiFi-GAN on its frames), over the window and the card's
published dense peak in the configuration's compute dtype."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin("metrics", "mfu.offline").read(ctx)
