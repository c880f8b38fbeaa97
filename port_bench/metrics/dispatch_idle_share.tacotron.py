"""The share of the window in which the device waited while the program
queued its work, in the Tacotron2 cell: 100 x the idle of every device gap
whose middle lies inside a `tts` call but inside neither `tts.frontend`
nor `tts.collect`, over the window (`dispatch_idle_share.offline`'s
arithmetic). In this cell it holds the gaps between the decode's small
kernels and at each block's host read of the run flag. Nothing to read
where the program records no `tts` span."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin(
        "metrics", "dispatch_idle_share.offline").read(ctx)
