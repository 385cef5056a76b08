"""Device ms an image of the feature stage: CUDA events the harness records on
the current stream around the pipeline's feature call, mean over the
window's images."""


def read(run):
    times = run.stage_ms.get("feature") or []
    return sum(times) / len(times) if times else None
