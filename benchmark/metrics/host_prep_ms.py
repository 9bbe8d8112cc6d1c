"""Host ms a call in the solver classes before the driver starts: from
the entry's ``bench.lw_solve`` / ``bench.sw_solve`` range around each
``solve()`` to the host-side start of the driver's first range
(``lw_inputs`` / ``sw_inputs``), summed over LW and SW (validation, the
dtype rule, vmr packing, the dry-air column, casts and copies)."""

FIRST = {"bench.lw_solve": "lw_inputs", "bench.sw_solve": "sw_inputs"}


def read(trace, cell):
    total, seen = 0.0, 0
    for name, s, _ in trace.host_ranges:
        if name not in FIRST:
            continue
        starts = [t for n, t, _ in trace.host_ranges
                  if n == FIRST[name] and t >= s]
        if not starts:
            return None
        total += min(starts) - s
        seen += 1
    if seen == 0:
        return None
    return total / trace.calls / 1e3
