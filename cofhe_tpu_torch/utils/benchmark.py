"""Benchmark timer with the reference's reporting semantics
(benchmarks/benchmark.hpp:5-146): run a callable N times, report
first/last/average/median/total milliseconds, and autosave results to
`benchmark_results_<tag><datetime>.txt` periodically. The port's copy of
cofhe_tpu/utils/benchmark.py; PhaseTimer is the by-name seconds view over the
port's tracer (utils/trace.py), and marks its phases in torch.profiler
traces (and NVTX ranges on a CUDA device)."""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from . import trace


@dataclass
class Benchmark:
    tag: str = ""
    autosave_interval_s: float = 600.0
    results_ms: list[float] = field(default_factory=list)
    _last_save: float = field(default_factory=time.time)

    def run(self, fn, n: int = 1, *args, **kwargs):
        out = None
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.results_ms.append((time.perf_counter() - t0) * 1e3)
            if time.time() - self._last_save > self.autosave_interval_s:
                self.autosave()
        return out

    # -- stats (benchmark.hpp:83-94) ---------------------------------------
    def first(self) -> float:
        return self.results_ms[0]

    def last(self) -> float:
        return self.results_ms[-1]

    def average(self) -> float:
        return sum(self.results_ms) / len(self.results_ms)

    def median(self) -> float:
        return statistics.median(self.results_ms)

    def total(self) -> float:
        return sum(self.results_ms)

    def summary(self) -> str:
        return (f"first: {self.first():.3f} ms, last: {self.last():.3f} ms, "
                f"average: {self.average():.3f} ms, median: {self.median():.3f} ms, "
                f"total: {self.total():.3f} ms ({len(self.results_ms)} runs)")

    def autosave(self, path: str | None = None) -> str:
        if path is None:
            stamp = time.strftime("%Y%m%d_%H%M%S")
            path = f"benchmark_results_{self.tag}{stamp}.txt"
        with open(path, "w") as f:
            f.write(self.summary() + "\n")
            for ms in self.results_ms:
                f.write(f"{ms:.6f}\n")
        self._last_save = time.time()
        return path


class PhaseTimer:
    """Seconds by phase name over the port's tracer (utils/trace.py): each
    phase is timed on the span's clock, recorded as a span while tracing
    is on, and a torch.profiler.record_function range, so it shows in a torch.profiler
    trace under its name; on a CUDA `device` it is also an NVTX range for
    CUDA tools. Seconds accumulate by name over repeated phases. Work
    queued on the card is not waited for: a caller that times device work
    synchronizes before the phase ends."""

    def __init__(self, device=None):
        self.phases: dict[str, float] = {}
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __call__(self, name: str):
        return trace.phase(name, self._add, nvtx=self.cuda)

    def _add(self, span) -> None:
        self.phases[span.name] = self.phases.get(span.name, 0.0) + span.seconds

    def report(self) -> str:
        return ", ".join(f"{k}: {v * 1e3:.1f} ms" for k, v in self.phases.items())
