"""Start the ranks of a multi-process run on one host and collect what they return.

:func:`spawn_workers` starts ``world`` processes with the ``spawn`` method
(a child imports only what its target's module imports), gives them a
process group over a file rendezvous in a fresh temporary directory (no TCP
port to collide on), runs ``target(*args)`` in each and returns every rank's
result in rank order. A rank that raises, dies or outlives ``timeout`` fails
the whole call: the ranks that are left are killed and the error is raised
here; nothing carries on. The target must be a module-level function (it is
pickled by reference); arguments and results must pickle.

Devices: ``device="cpu"`` runs every rank on the host over ``gloo`` with one
intra-op thread each. ``device="cuda"`` gives rank r the card ``r % n`` of the
``n`` visible ones; the backend is ``nccl`` when every rank has a card of its
own and ``gloo`` when ranks share one (NCCL refuses two ranks on one device).
A rank reads its device from :func:`worker_device`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch

_DEVICE = None  # this rank's device, set by _entry or init_from_env


def worker_device() -> torch.device:
    if _DEVICE is None:
        raise RuntimeError("worker_device: not inside a rank started by parallel/launch.py")
    return _DEVICE


def choose_backend(device: str, world: int) -> str:
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init(rank: int, world: int, init_method: str, device: str, timeout: float) -> None:
    import torch.distributed as dist

    global _DEVICE
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA card is available")
        _DEVICE = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(_DEVICE)
    else:
        _DEVICE = torch.device("cpu")
        torch.set_num_threads(1)
    kwargs = {}
    backend = choose_backend(device, world)
    if backend == "nccl":
        kwargs["device_id"] = _DEVICE
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kwargs)


def init_from_env(device: str, timeout: float = 1800.0) -> tuple[int, int]:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns (rank, world)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _init(rank, world, "env://", device, timeout)
    return rank, world


def shutdown() -> None:
    import torch.distributed as dist

    global _DEVICE
    _DEVICE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank, world, init_file, device, timeout, target, args, out_dir):
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        _init(rank, world, f"file://{init_file}", device, timeout)
        result = target(*args)
        if device == "cuda":
            torch.cuda.synchronize()
        shutdown()
        payload = ("ok", result)
    except (Exception, SystemExit):  # reported to the parent, which raises; this rank ends below
        payload = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out + ".tmp", out)
    if payload[0] == "error":
        os._exit(1)  # do not wait for peers that are stuck in a collective


def run_in_process(target, args, device: str, timeout: float = 600.0):
    """A world of one in this process: the same path as :func:`spawn_workers`
    without a child (the group is destroyed afterwards)."""
    with tempfile.TemporaryDirectory(prefix="hgl_dist_") as tmp:
        threads = torch.get_num_threads()
        try:
            _init(0, 1, f"file://{os.path.join(tmp, 'rendezvous')}", device, timeout)
            return [target(*args)]
        finally:
            shutdown()
            torch.set_num_threads(threads)


def spawn_workers(target, world: int, args, device: str, timeout: float = 600.0):
    """Run ``target(*args)`` on ``world`` ranks; returns their results in rank
    order. Raises RuntimeError if a rank fails, and TimeoutError (after
    killing every rank) if the run outlives ``timeout`` seconds. A single
    collective may wait the smaller of ``timeout`` and 1800 seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hgl_dist_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        wait = min(timeout, 1800.0)
        procs = [ctx.Process(target=_entry, args=(r, world, init_file, device, wait, target, args, tmp), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0]
                if bad:
                    failed = bad
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {target.__name__} did not finish in {timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        results, errors = [], {}
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                if failed is None or r in failed:
                    errors[r] = f"rank {r} of {target.__name__} died with exit code {p.exitcode}"
                continue  # else: killed because a peer failed
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors[r] = f"rank {r} of {target.__name__} failed:\n{value}"
            else:
                results.append(value)
        if errors:  # the rank that was seen to fail first leads: its peers' errors follow from it
            order = sorted(errors, key=lambda r: (failed is None or r not in failed, r))
            raise RuntimeError("\n".join(errors[r] for r in order))
        if len(results) != world:
            raise RuntimeError(f"ranks of {target.__name__} were lost (exit codes {[p.exitcode for p in procs]})")
        return results
