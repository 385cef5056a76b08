"""The host's waits on the card an image: the program's ``StageTimer`` span
``host_wait`` (the hand-off's event wait, a copy of rows past its prefetched
head, a read of a bundle's count and validity from the device) counted over
the window, over its images. None where the program has no such span."""


def read(run):
    t = run.timer
    if not t or not t["counts"].get("proposals_dispatch") or "host_wait" not in t["counts"]:
        return None
    return t["counts"]["host_wait"] / t["counts"]["proposals_dispatch"]
