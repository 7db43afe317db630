"""Share of the profiled training steps in which no operation ran on the
device: 1 - (union of the device's activity intervals / the slice's wall
time), in percent."""


def read(record):
    summary = record.get("trace")
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
