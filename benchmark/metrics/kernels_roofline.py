"""The port's own kernels' share of their roofline in the traced tail: the
least time the card could take for every launch the tail made (operations
or bytes at the published peaks, ``benchlib/kernels.py``) over the device
time of those kernels in the trace, percent. Nothing where the trace's own
kernels are not, label by label, the launches the model counts (a kernel
fused, dropped or renamed since): the bound would be of other work."""


def read(run):
    tail = run.tail
    if not tail or not tail["launches_match"] or tail["own_ms"] <= 0 or tail["bound_ms"] <= 0:
        return None
    return 100.0 * tail["bound_ms"] / tail["own_ms"]
