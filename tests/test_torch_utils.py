"""The port's utils/benchmark.py: Benchmark's statistics and saved file
against the JAX package's class on one list of timings, and PhaseTimer's
accumulated seconds and its ranges in a CPU torch.profiler trace."""

import torch
from torch.profiler import ProfilerActivity, profile

from cofhe_tpu.utils.benchmark import Benchmark as JaxBenchmark
from cofhe_tpu_torch.utils.benchmark import Benchmark, PhaseTimer

TIMINGS_MS = [12.5, 3.25, 7.0, 100.125, 0.5, 7.0]


def test_benchmark_statistics_match_the_jax_class(tmp_path):
    ours, theirs = Benchmark(tag="x"), JaxBenchmark(tag="x")
    ours.results_ms[:] = TIMINGS_MS
    theirs.results_ms[:] = TIMINGS_MS
    for stat in ("first", "last", "average", "median", "total", "summary"):
        assert getattr(ours, stat)() == getattr(theirs, stat)(), stat
    a = ours.autosave(str(tmp_path / "ours.txt"))
    b = theirs.autosave(str(tmp_path / "theirs.txt"))
    assert open(a).read() == open(b).read()


def test_benchmark_run_times_each_call():
    calls = []
    bench = Benchmark()
    assert bench.run(lambda x: calls.append(x) or x * 2, 3, 21) == 42
    assert calls == [21, 21, 21] and len(bench.results_ms) == 3
    assert all(ms >= 0 for ms in bench.results_ms)


def test_phase_timer_accumulates_and_marks_the_trace():
    timer = PhaseTimer("cpu")
    assert not timer.cuda
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer("compose_phase"):
                torch.ones(64).cumsum(0)
        with timer("gather_phase"):
            pass
    assert set(timer.phases) == {"compose_phase", "gather_phase"}
    assert timer.phases["compose_phase"] > 0
    names = [e.name for e in prof.events()]
    assert names.count("compose_phase") == 3 and "gather_phase" in names
    assert "compose_phase:" in timer.report()
