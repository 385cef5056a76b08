"""Host ms an image of the proposal dispatch (upload, graph launch, hand-off),
the program's ``StageTimer`` span ``proposals_dispatch`` (no synchronisation),
mean over the window's images."""


def read(run):
    t = run.timer
    if not t or not t["counts"].get("proposals_dispatch"):
        return None
    return 1e3 * t["totals"]["proposals_dispatch"] / t["counts"]["proposals_dispatch"]
