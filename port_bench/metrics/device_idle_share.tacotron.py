"""The share of the window in which no operation ran on the device, in the
Tacotron2 cell (`device_idle_share.offline`'s arithmetic: 100 minus the
union of the device operations' intervals over the window)."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin("metrics",
                               "device_idle_share.offline").read(ctx)
