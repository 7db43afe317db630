"""Wall milliseconds per decode step: the time inside the family's
``decode_steps`` calls of the window (each ends in the copy of its tokens
to the host) over the steps they ran.  Calls inside the profiled slice are
left out, since the profiler slows them."""


def read(record):
    calls = [c for c in record.get("decode_calls", []) if not c["traced"]]
    steps = sum(c["n"] for c in calls)
    if not steps:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / steps
