"""The MRF ResBlock1 kernels' share of their roofline: the least time of
every ResBlock the window's generator calls ran (the frozen `bound()`,
each byte counted once, from the calls' mel shapes), over the device
time of the kernels named `resblock1*`. Nothing to read where no such
kernel ran."""
from port_bench import yardstick


def read(ctx):
    kernel_s = ctx.trace.op_seconds("resblock1")
    if kernel_s <= 0:
        return None
    h = ctx.program.config["hifigan"]
    bound_s = sum(yardstick.generator_resblock_bound_s(h, shape,
                                                        ctx.program.dtype)
                  for shape in ctx.generator_calls)
    return 100.0 * bound_s / kernel_s
