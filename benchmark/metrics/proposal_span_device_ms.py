"""Stream ms an image of the proposal dispatch (the upload, the graph
launch, the hand-off): the program's ``StageTimer`` span
``proposals_dispatch`` timed on the stream by its own CUDA events
(``proposals_dispatch@device``, seconds), mean over the window's images. None
where the program does not time its spans on the stream."""

KEY = "proposals_dispatch@device"


def read(run):
    t = run.timer
    if not t or not t["counts"].get(KEY):
        return None
    return 1e3 * t["totals"][KEY] / t["counts"][KEY]
