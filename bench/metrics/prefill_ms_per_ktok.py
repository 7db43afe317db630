"""Wall milliseconds per thousand prompt tokens prefilled: the time inside
the family's ``prefill_batch`` calls of the window over the prompt tokens
they advanced.  Calls inside the profiled slice are left out."""


def read(record):
    calls = [c for c in record.get("prefill_calls", []) if not c["traced"]]
    tokens = sum(int(c["counts"].sum()) for c in calls)
    if not tokens:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / (tokens / 1e3)
