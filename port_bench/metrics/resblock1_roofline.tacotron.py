"""The MRF ResBlock1 kernels' share of their roofline in the Tacotron2
cell (`resblock1_roofline.offline`'s arithmetic: the frozen least time of
every ResBlock the window's generator calls ran, over the device time of
the kernels named `resblock1*`). Nothing to read where no such kernel
ran."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin(
        "metrics", "resblock1_roofline.offline").read(ctx)
