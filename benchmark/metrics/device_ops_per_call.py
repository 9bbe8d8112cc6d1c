"""Device operations (kernels, copies, fills) on the card's timeline a
call: the driver's launch count, which sets the host's enqueue time."""


def read(trace, cell):
    if not trace.ops:
        return None
    return len(trace.ops) / trace.calls
