"""Stream ms an image of the sentence stage: the program's ``StageTimer`` span
``sentence_stage`` timed on the stream by its own CUDA events
(``sentence_stage@device``, seconds), mean over the window's images. None
where the program does not time its spans on the stream."""

KEY = "sentence_stage@device"


def read(run):
    t = run.timer
    if not t or not t["counts"].get(KEY):
        return None
    return 1e3 * t["totals"][KEY] / t["counts"][KEY]
