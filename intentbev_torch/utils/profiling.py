"""Tracing and metrics hooks: the counterpart of ``intentbev/utils/profiling.py``.

- ``trace_context``: a ``torch.profiler`` trace of the enclosed block (CPU
  and CUDA activity), exported as a Chrome trace into ``log_dir``.
- ``StepTimer``: step timing with rolling frames/s; ``stop`` waits for the
  device (``torch.cuda.synchronize``) when the step's result is on a GPU.
- ``MetricsLogger``: structured JSONL metrics.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir`` is
    set; the trace lands in ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _on_cuda(result) -> bool:
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_cuda(v) for v in result.values())
    if isinstance(result, (list, tuple)):
        return any(_on_cuda(v) for v in result)
    return False


class StepTimer:
    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None and _on_cuda(result):
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._last
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def frames_per_sec(self, batch_size: int) -> float:
        m = self.mean_step_s
        return batch_size / m if m > 0 else 0.0


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **metrics):
        if not self.path:
            return
        rec = {"step": step, "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
