"""Stream ms an image of the feature stage: the program's ``StageTimer`` span
``crops+fusion`` timed on the stream by its own CUDA events
(``crops+fusion@device``, seconds), mean over the window's images. None
where the program does not time its spans on the stream."""

KEY = "crops+fusion@device"


def read(run):
    t = run.timer
    if not t or not t["counts"].get(KEY):
        return None
    return 1e3 * t["totals"][KEY] / t["counts"][KEY]
