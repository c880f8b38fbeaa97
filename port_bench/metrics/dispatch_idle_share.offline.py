"""The share of the window in which the device waited while the program
queued its work: 100 x the idle time of every device gap of the window
(`Trace.gaps()`, all of them) whose middle lies inside a `tts` call but
inside neither of its host stages, `tts.frontend` (tokenizing) and
`tts.collect` (the copies back and the crops), over the window. So it
holds the gaps in the encode, decode, vocoder and denoiser stages and
the host read between the encodes and the decodes. The rest of
`device_idle_share.offline` is idle time in the host stages and with no
call open (the caller's, between calls). Nothing to read where the
program records no `tts` span."""
import bisect

from port_bench import harness

HOST_STAGES = ("tts.frontend", "tts.collect")


def intervals(spans) -> list:
    """The union of the spans' intervals [(start s, end s)], sorted."""
    out = []
    for s, e in sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def inside(union: list, t: float) -> bool:
    i = bisect.bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and t <= union[i][1]


def read(ctx):
    encode = harness.load_plugin("metrics",
                                 "encode_device_us_per_audio_s.offline")
    spans = encode.window_spans(ctx) or ()
    calls = intervals(s for s in spans if s.name == "tts")
    if not calls:
        return None
    host = intervals(s for s in spans if s.name in HOST_STAGES)
    idle = 0.0
    for a, b in ctx.trace.gaps():
        mid = 0.5 * (a + b)
        if inside(calls, mid) and not inside(host, mid):
            idle += b - a
    return 100.0 * idle / ctx.trace.window_s
