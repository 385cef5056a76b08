"""Device ms an image of the proposal stage: CUDA events the harness records on
the current stream around the pipeline's proposal call, mean over the
window's images."""


def read(run):
    times = run.stage_ms.get("proposal") or []
    return sum(times) / len(times) if times else None
