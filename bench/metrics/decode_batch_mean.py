"""Mean number of sequences in a decode step over the window: each
``decode`` step record of the scheduler counts its ``n_active`` once."""


def read(record):
    xs = record.get("decode_n_active")
    return sum(xs) / len(xs) if xs else None
