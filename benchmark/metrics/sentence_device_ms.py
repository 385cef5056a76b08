"""Device ms an image of the sentence stage: CUDA events the harness records on
the current stream around the pipeline's sentence call, mean over the
window's images."""


def read(run):
    times = run.stage_ms.get("sentence") or []
    return sum(times) / len(times) if times else None
