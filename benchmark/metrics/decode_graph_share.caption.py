"""decode_graph_share.caption: share of the decode steps in the traced slice
that ran as one CUDA graph replay, %: complete ``c3d.caption.step`` spans
that hold a complete ``c3d.caption.replay`` span, over all complete
``c3d.caption.step`` spans. None when the slice holds no step span, or no
replay span at all (a program that does not replay graphs). A span is
complete as ``benchlib/spans.py`` takes it: one that ends within a
microsecond of the slice's last instant was cut by the profiler's stop."""

import bisect


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    end = t.start_us + t.window_us - 1.0
    complete = lambda name: sorted((s, e) for n, s, e in t.host if n == name and s < e < end)
    steps, replays = complete("c3d.caption.step"), complete("c3d.caption.replay")
    if not steps or not replays:
        return None
    starts = [s for s, _ in replays]
    held = 0
    for s, e in steps:
        i = bisect.bisect_left(starts, s)
        held += i < len(replays) and replays[i][1] <= e
    return 100.0 * held / len(steps)
