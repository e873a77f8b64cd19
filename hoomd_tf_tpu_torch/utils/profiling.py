"""Profiling and benchmarking helpers (PyTorch port of
``hoomd_tf_tpu/utils/profiling.py``).

The reference piggybacks on HOOMD's Profiler push/pop brackets and a CUDA
block-size Autotuner (SURVEY.md section 5). Here a trace is
``torch.profiler``'s, exported as a Chrome trace (view it in Perfetto or
``chrome://tracing``), and a step time is the wall time of whole
``run(steps)`` calls, each closed by a synchronize of the state's device
(PyTorch returns before the card finishes).
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["trace", "time_steps", "benchmark_simulation"]


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Profile the block and write a Chrome trace into ``log_dir`` (a new
    ``trace_*.json`` each time); yields the ``torch.profiler.profile``, so
    ``prof.key_averages()`` reads the same window.

    :param device: the device the traced simulation runs on (a
        ``Simulation``'s ``.device``; default: the CUDA card, pass
        ``device="cpu"`` for the CPU). On the card the trace records the
        CPU and the card's kernels, and raises when the profiler cannot
        record CUDA activity or recorded none; on the CPU it records the
        CPU only.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device = resolve_device(device, "trace")
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity "
                               "in this build")
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    if cuda and not any(e.device_type == DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity in a "
                           "trace of a run on the card")
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json",
                                dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)


def _sync(sim):
    dev = sim.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_steps(sim, steps, reps=1):
    """Honest per-step wall time: warms the run first (builds, plans,
    allocations), then times whole ``run(steps)`` calls, each clock read
    after a synchronize of the state's device.

    :return: dict with ``ms_per_step``, ``steps_per_s`` (of the fastest
        call) and ``all_runs_s``.
    """
    sim.run(steps)
    _sync(sim)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.run(steps)
        _sync(sim)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"ms_per_step": best / steps * 1000.0,
            "steps_per_s": steps / best,
            "all_runs_s": times}


def benchmark_simulation(sim, steps=1000, equilibration=0, reps=3):
    """pytest-benchmark-style measurement (the reference's
    ``test-py/benchmark.py`` protocol: equilibrate, then time R rounds of
    K steps; report mean/min)."""
    if equilibration:
        sim.run(equilibration)
        _sync(sim)
    r = time_steps(sim, steps, reps=reps)
    runs = np.asarray(r["all_runs_s"])
    return {
        "steps": steps,
        "rounds": reps,
        "mean_s": float(runs.mean()),
        "min_s": float(runs.min()),
        "stddev_s": float(runs.std()),
        "steps_per_s": steps / float(runs.min()),
    }
