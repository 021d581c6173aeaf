"""Timing and tracing helpers (counterpart of tinyknn_tpu/utils/timing.py).

A print-based wall-clock timer, ``block`` to wait for the device work
behind a result before a host clock is read (PyTorch returns from a
CUDA call before the card has finished it), a ``torch.profiler`` trace
scope, and the switch that points the kernels' build directory at a
cache of the caller's choosing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path

import torch


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
    ``logdir`` when it closes; does nothing when ``logdir`` is None."""
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
