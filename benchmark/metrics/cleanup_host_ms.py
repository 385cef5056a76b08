"""Host ms an image of the small-region cleanup (the hand-off's wait excluded),
the program's ``StageTimer`` span ``small_region_cleanup``, mean over the
window's images."""


def read(run):
    t = run.timer
    if not t or not t["counts"].get("small_region_cleanup"):
        return None
    return 1e3 * t["totals"]["small_region_cleanup"] / t["counts"]["small_region_cleanup"]
