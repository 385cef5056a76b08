"""The device's idle share in the traced tail: 1 - (the union of its kernel,
copy and fill intervals) / the tail's wall, percent."""


def read(run):
    tail = run.tail
    if not tail or tail["wall_ms"] <= 0:
        return None
    return 100.0 * (1.0 - tail["busy_ms"] / tail["wall_ms"])
