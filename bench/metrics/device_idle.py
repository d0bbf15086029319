"""device_idle: 1 - the union of the device operations' intervals over the
profiled slice's wall time."""


def read(rec):
    s = rec.slice
    return None if s is None else 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
