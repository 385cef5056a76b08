"""The port's own copy of ``hybridgl_tpu/data/prefetch.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

Double-buffered host->device input prefetch.

The reference blocks the accelerator on host work between every model call
(JPEG decode, cv2, spaCy — reference: Hybridgl_main.py:79-125). Here a
background thread pool decodes and builds ImageSamples ahead of the
device, so the TPU never stalls on input. jax dispatch is async, so simply
having the next sample's numpy arrays ready is enough — transfers overlap
with the previous image's compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run the producer iterator in a daemon thread, ``depth`` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item


class IndexedPrefetcher:
    """Prefetch ``dataset[i]`` with a small worker pool (order-preserving).

    A pool beats a single producer thread when per-item host work (JPEG
    decode + polygon rasterisation) exceeds device step time.
    """

    def __init__(self, dataset, workers: int = 2, depth: int = 4):
        self.dataset = dataset
        self.workers = max(1, workers)
        self.depth = depth

    def __iter__(self):
        import concurrent.futures as cf

        n = len(self.dataset)
        with cf.ThreadPoolExecutor(self.workers) as pool:
            futures: "queue.Queue" = queue.Queue()
            next_submit = 0

            def submit_upto(k):
                nonlocal next_submit
                while next_submit < min(k, n):
                    futures.put(pool.submit(self.dataset.__getitem__, next_submit))
                    next_submit += 1

            submit_upto(self.depth)
            for i in range(n):
                fut = futures.get()
                submit_upto(i + 1 + self.depth)
                yield fut.result()
