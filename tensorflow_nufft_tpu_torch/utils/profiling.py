"""Profiling, tracing and verbosity utilities.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- **Spans** (``scope``): every stage of a transform (fold/rescale,
  spread, the mode stage, interp; type-3's outer spread and inner
  type-2) runs inside a ``torch.profiler.record_function`` of its JAX
  name, so ``torch.profiler`` traces show each stage as a span with the
  host ops and device kernels it launched under it. Under
  ``torch.autograd.profiler.emit_nvtx()`` the same spans become NVTX
  ranges. Without an active profiler a span opens no
  ``record_function`` (which costs about 10 microseconds of host time)
  and costs one check of the profiler state. The layers above the
  stages have spans of their own, named apart from the JAX scopes:
  ``mri.forward``, ``mri.adjoint``, ``mri.normal`` and ``cg.iter`` (the
  MRI models), ``plan.apply``, ``plan.normal`` and ``plan.slots``
  (``PlannedNufft``, whose stages also run under the stage names, as
  the JAX planned path's do not) and ``prep.bin`` (the binning, inside
  ``nufft.fold_rescale``).
- **Host annotations** (``annotate``): the same, for host-side phases.
- **Device tracing** (``start_trace``/``stop_trace``/``trace``): a
  ``torch.profiler`` session of CPU and (where present) CUDA activity
  that writes a Chrome/TensorBoard trace into a directory.
- **Verbosity** (``set_verbosity``/``log``): stderr logging, the level
  from ``TFFT_VERBOSITY`` (default 0 = silent).
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import torch

_verbosity = int(os.environ.get("TFFT_VERBOSITY", "0") or 0)
_session: Optional[torch.profiler.profile] = None


def set_verbosity(level: int) -> None:
    """Sets the global log verbosity (0 = silent, 1 = stage summaries,
    2 = per-call detail)."""
    global _verbosity
    _verbosity = int(level)


def verbosity() -> int:
    """Current log verbosity."""
    return _verbosity


def log(level: int, msg: str) -> None:
    """Writes ``msg`` to stderr when ``verbosity() >= level``."""
    if _verbosity >= level:
        print(f"[tfft] {msg}", file=sys.stderr, flush=True)


class _Span:
    """A ``record_function`` of ``name`` while a profiler (or
    ``emit_nvtx``) is active, else nothing."""

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        span, self._span = self._span, None
        if span is not None:
            span.__exit__(*exc)
        return False


def scope(name: str):
    """A named span for a pipeline stage (a context manager): a
    ``record_function`` in profiler traces and an NVTX range under
    ``emit_nvtx``, nothing when no profiler is active."""
    return _Span(name)


def annotate(name: str):
    """A host-side span, as ``scope``; a no-op outside a profiler
    session."""
    return _Span(name)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    """Waits for the card's work where this process uses CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace(logdir: str) -> None:
    """Starts a ``torch.profiler`` session of CPU and CUDA activity whose
    trace ``stop_trace`` writes into ``logdir``."""
    global _session
    if _session is not None:
        raise RuntimeError("a trace is already running")
    os.makedirs(logdir, exist_ok=True)
    session = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    session.start()
    _session = session


def stop_trace() -> None:
    """Stops the session of ``start_trace`` and writes its trace (a
    ``.pt.trace.json`` file, Chrome- and TensorBoard-loadable)."""
    global _session
    if _session is None:
        raise RuntimeError("no trace is running")
    session, _session = _session, None
    _sync()
    session.stop()


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager: profile the enclosed block to ``logdir``."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
