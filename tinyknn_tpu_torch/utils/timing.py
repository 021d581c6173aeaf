"""Timing and tracing helpers (counterpart of tinyknn_tpu/utils/timing.py).

A print-based wall-clock timer, ``block`` to wait for the device work
behind a result before a host clock is read (PyTorch returns from a
CUDA call before the card has finished it), a ``torch.profiler`` trace
scope, and the switch that points the kernels' build directory at a
cache of the caller's choosing.

The query path names its stages with ``span``: while a ``torch.profiler``
session records (``profile_trace``, or any profiler the caller opens),
each stage is a ``record_function`` range in the profiler's host
timeline, on the clock of the CUDA events it enqueues; otherwise a span
costs one check. ``IVF.query`` opens ``tinyknn.query`` and, inside it,
``tinyknn.input`` (the queries' copy to the device), then either
``tinyknn.gather`` (gather mode) or one ``tinyknn.attempt`` per
bucket-mode pass (``tinyknn.retry`` for the passes after the first),
each holding ``tinyknn.tables``, ``tinyknn.probes``, a
``tinyknn.bucket`` and a ``tinyknn.scan`` per scan round,
``tinyknn.pool`` and ``tinyknn.rescore``, and after each pass
``tinyknn.drop_check`` (the host's read of the dropped-pair count).
``IVF.query_stream`` opens ``tinyknn.query_stream`` over the same
stages, one pass per batch. In a trace, a device op belongs to the
innermost ``tinyknn.*`` range open when the runtime call that enqueued
it was made (the trace links the two by their correlation id).

``counters`` holds process-wide counts that the query path adds to
where the work happens; a reader takes differences over its window:
``query.attempts``, the bucket-mode passes over a batch;
``query.dropped_pairs``, the (query, probe) pairs those passes dropped,
counted where the host reads them (``query_stream(device_out=True)``
reads none and counts none); ``query.rescued_pairs``, the pairs
that overflowed their bucket in ``IVF.query``'s first pass, or past
the caps in its last, and were scanned in that pass's overflow grid
instead of dropped (read in the same transfer as the drops); and ``query.lost_pairs``, the pairs that a
batch's answer never scanned: those that the last pass of ``query()``
still dropped (where ``queries_per_cluster`` pins the capacities, or
where the 'xla' engine or ``ShardedIVF.query``, which scan no overflow
grid, meet caps that ``scan_budget_bytes`` clamps below the fullest
list), and every drop that ``query_stream``'s host path reads, since it
has no retry.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

counters = {"query.attempts": 0, "query.dropped_pairs": 0,
            "query.rescued_pairs": 0, "query.lost_pairs": 0}

_NO_SPAN = nullcontext()


def span(name: str):
    """A context manager naming a stage ``name`` in the profiler's host
    timeline while a ``torch.profiler`` session records; otherwise one
    shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextmanager
def timer(verbose, text):
    """Wall-clock timer context manager; prints when ``verbose``."""
    if verbose:
        print(text)
        start = time.time()
    yield
    if verbose:
        print(f"Took {time.time() - start:.1f}s")


def _cuda_devices(tree, found: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):      # NamedTuples included
        for v in tree:
            _cuda_devices(v, found)


def block(tree):
    """Wait until the work behind every tensor of ``tree`` (a tensor, or
    nested lists, tuples, NamedTuples and dicts of them) is done:
    synchronize each CUDA device that holds one of them (a CPU tensor
    is ready when it is returned). Returns ``tree``."""
    found = set()
    _cuda_devices(tree, found)
    for device in found:
        torch.cuda.synchronize(device)
    return tree


@contextmanager
def profile_trace(logdir=None):
    """``torch.profiler`` scope over the CPU and CUDA activities that
    writes a Chrome/TensorBoard trace (``*.pt.trace.json``) under
    ``logdir`` when it closes; does nothing when ``logdir`` is None.

    The trace carries the query path's stages as ``tinyknn.*`` host
    ranges (see the module's docstring): in a trace viewer, a kernel's
    flow arrow leads back to its launch, which sits inside the stage
    that enqueued it; ``torch.profiler``'s ``key_averages()`` lists each
    stage's host time under its name."""
    if logdir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def enable_compilation_cache(path=None, min_compile_secs=1.0):
    """Keep the kernels' builds under ``path`` (default: ``_build/``
    beside the package's sources, where they go anyway).

    The port's only compilations are the nvcc builds of its CUDA
    kernels (``ops/_build.py``); each lands in a file named by a hash of
    its source, so a later process finds and loads it. This points
    ``_build.BUILD_DIR`` at ``path`` for builds made after the call; a
    kernel already loaded in this process stays loaded.
    ``min_compile_secs`` is accepted for parity with the JAX package and
    has no effect: every kernel is kept, since an nvcc build takes
    seconds."""
    del min_compile_secs
    from ..ops import _build
    _build.BUILD_DIR = (_build.DEFAULT_BUILD_DIR if path is None
                        else Path(path))
