"""Stream ms an image outside the three stage spans: the program's top-level
``StageTimer`` spans' stream time (``<name>@device``) and the stream time
between them (``<name>@gap``), which together cover the stream from the
first span's entry to the last one's exit, less the proposal, feature and
sentence spans' ``@device``, over the window's images. It is the time the
stream waited on the host or ran work queued outside those stages (the
results' copy, the host cleanup's uploads). None where the program does not
time its spans on the stream."""

STAGES = ("proposals_dispatch", "crops+fusion", "sentence_stage")


def read(run):
    t = run.timer
    if not t or not t["counts"].get("proposals_dispatch"):
        return None
    totals = t["totals"]
    if not any(k.endswith("@gap") for k in totals):
        return None
    top = sum(v for k, v in totals.items() if k.endswith("@gap") or (k.endswith("@device") and "/" not in k))
    stages = sum(totals.get(f"{s}@device", 0.0) for s in STAGES)
    return 1e3 * (top - stages) / t["counts"]["proposals_dispatch"]
