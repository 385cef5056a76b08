"""Stream ms an image of GEM's patch features (``gem_image_features``): the
program's device span ``gem`` inside the captured feature graph (an event
pair recorded into the graph, ``utils/profiling.py:device_span``), folded
after each replay under the open ``crops+fusion`` span
(``crops+fusion/gem@device``, seconds), mean over the window's images. None
where the program has no such span, and where a pair was not read before
its graph replayed again (``span_missed``): the mean would leave out images."""

KEY = "crops+fusion/gem@device"


def read(run):
    t = run.timer
    if not t or not t["counts"].get(KEY) or t["counts"].get("span_missed"):
        return None
    return 1e3 * t["totals"][KEY] / t["counts"][KEY]
