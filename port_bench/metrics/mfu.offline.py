"""Model FLOPs utilization of the window: the FLOPs of every utterance it
completed, at its own tokens and frames (the benchmark's frozen counts:
encode, decode and the generator), over the window and the card's
published dense peak in the configuration's compute dtype."""
from port_bench import yardstick


def read(ctx):
    flops = sum(ctx.program.flops(text, n) for text, n in ctx.served)
    peak = yardstick.PEAK_FLOPS[ctx.program.dtype]
    return 100.0 * flops / ctx.trace.window_s / peak
