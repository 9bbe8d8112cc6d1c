"""Share (%) of the captured calls' span (host side, each call ending in
a synchronize) in which nothing ran on the card."""


def read(trace, cell):
    if not trace.ops:
        return None
    w0, w1 = trace.window
    return 100.0 * (1.0 - trace.busy_us() / (w1 - w0))
