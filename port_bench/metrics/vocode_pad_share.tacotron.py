"""The share of the frames HiFi-GAN vocodes that no utterance keeps, in the
Tacotron2 cell: `vocode_pad_share.offline`'s arithmetic (100 x (1 - the
`frames_kept` of the `tts.collect` spans / the `frames_vocoded` of the
`tts.vocode` spans)); `Tacotron2Wave` vocodes each batch whole at the mel
bucket of its longest row. Nothing to read where the program records no
such span or count."""
from port_bench import harness


def read(ctx):
    return harness.load_plugin("metrics",
                               "vocode_pad_share.offline").read(ctx)
