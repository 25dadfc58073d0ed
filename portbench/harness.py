"""The benchmark's harness: finds a cell's configuration, traffic and
metrics by the names in BENCHMARK.json, builds the deployment, warms it
up, runs the measured window (or the traced one), compares the outputs
with the plain reference and returns the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* portbench/configs/<config>.json: the deployment (its `file` in
  BENCHMARK.json);
* portbench/traffic/<traffic>.json: the op and its sizes, read by the
  general generator in workload.py, which finds the op's code in
  portbench/ops/<op>.py;
* portbench/metrics/<metric>.py: `read(ctx)`, which returns the metric's
  value from the context below, or None where the run has nothing to
  read (the metric is then left out of the line).

The measured window is the op's `window`, by default a closed loop of one
client (workload.closed_loop). Rates count the work of every completed
request over the whole window; latencies are those of every request.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time

from . import deploy, reference, roofline, workload
from .trace import DeviceTrace, Spans, share_pct

FORBIDDEN = ("jax", "jaxlib", "flax", "cofhe_tpu")


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(workload entry, config entry) of cell `name`."""
    wls = {w["name"]: w for w in bench["workloads"]}
    if name not in wls:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: {sorted(wls)})")
    wl = wls[name]
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, cfg


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """Names of the `kind` ("end_to_end" or "per_layer") metrics that cell
    reports: those that list it, or list no cells."""
    return [m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_reader(root: str, name: str):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's (whole names: cofhe_tpu_torch is not cofhe_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def p90(xs) -> float:
    """90th percentile of every value (inclusive method: within the range
    of the values)."""
    return statistics.quantiles(xs, n=10, method="inclusive")[-1] if len(xs) > 1 else xs[0]


class Context:
    """What a metric reader sees: the window's requests (host clock
    intervals), the work a request completes, set-up seconds; in a traced
    run also the spans by label, per-request counters and the device
    trace."""

    def __init__(self, **kw):
        self.spans, self.counters, self.trace = {}, [], None
        self.__dict__.update(kw)

    @property
    def latencies(self) -> list:
        return [b - a for a, b in self.requests]

    def p90(self) -> float | None:
        return p90(self.latencies) if self.requests else None

    def rate(self) -> float | None:
        return len(self.requests) * self.units / self.window_s if self.requests else None

    def share(self, label: str) -> float | None:
        return share_pct(self.spans.get(label), self.requests)


def _replays(engines) -> int:
    return sum(g.replays for e in engines
               for g in e.cg.compose_graphs.graphs.values())


def cell_cards(cfg: dict) -> list:
    """The sorted distinct CUDA indices the configuration's devices name:
    "cuda" is the current card, 0; "cpu" and "host" name none."""
    if cfg["deployment"] == "local":
        devices = [cfg["device"]]
    else:
        devices = [*cfg["cofhe_devices"], cfg["compute_device"], cfg["client_device"],
                   cfg["setup_device"]]
    cards = set()
    for d in devices:
        if d in ("cpu", "host"):
            continue
        kind, _, index = d.partition(":")
        if kind != "cuda" or not (index or "0").isdigit():
            raise ValueError(f"device {d!r} is none of cpu, host, cuda, cuda:<index>")
        cards.add(int(index or 0))
    return sorted(cards)


def cards_missing(cell: str, need: int, have: int) -> str:
    return f"portbench: {cell} needs {need} CUDA card(s); this machine has {have}"


def _sync(torch, cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def _check_widths(dep, cfg: dict) -> None:
    cg = dep.engines()[0].cg
    got = {k: getattr(cg, k) for k in ("L", "Lh", "Lxn", "Lu", "Lm", "Lsq")}
    want = {k: cfg["widths"][k] for k in got}
    if got != want:
        raise RuntimeError(f"the program runs widths {got}, the configuration states {want}")


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, control: bool = False):
    """One run of `cell`: (result line, notes: the counts the comparison
    checked, set-up seconds by piece, every request's latency). `t_start`
    is the host clock at process start. The configuration names the
    devices (the CPU tests' toy configurations name "cpu"); a cell whose
    configuration names another count of cards than its `chips`, or a card
    this machine lacks, is refused before anything is built. With `control`,
    the result also holds under "control" the comparison of the control's
    outputs (the reference in the next lower precision, in the program's
    place) at the same requests."""
    import torch

    bench = load_json(root, "BENCHMARK.json")
    wl, cfg_entry = find_cell(bench, cell)
    cfg = load_json(root, cfg_entry["file"])
    traffic = load_json(root, os.path.join("portbench", "traffic", f"{wl['traffic']}.json"))
    cards = cell_cards(cfg)
    if cards and len(cards) != wl["chips"]:
        raise ValueError(f"{cell} asks for {wl['chips']} chip(s); its configuration "
                         f"names {len(cards)} card(s), {cards}")
    if cards and cards[-1] >= torch.cuda.device_count():
        raise RuntimeError(cards_missing(cell, cards[-1] + 1, torch.cuda.device_count()))
    group = reference.CLGroup(int(cfg["p"], 16), cfg["k"])
    if cards:
        torch.cuda.init()  # a card's memory statistics exist once CUDA is initialized
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)

    marks = [("imports", time.perf_counter())]
    dep = deploy.build(cfg, seed, group.secretkey_bound)
    try:
        marks.append(("deployment and keys", time.perf_counter()))
        _check_widths(dep, cfg)
        op, window = workload.make(root, dep, group, traffic, seed)
        marks.append(("inputs encrypted", time.perf_counter()))
        for w in range(traffic.get("warmup_requests", 1)):
            op.request(-1 - w, keep=False)
        _sync(torch, cards)
        # set-up's objects out of the collector's way: the window's collections
        # then scan what the requests allocate, the same in every run
        gc.collect()
        gc.freeze()
        marks.append(("warm-up requests", time.perf_counter()))
        ctx = Context(setup_s=marks[-1][1] - t_start, units=op.units,
                      config=cfg, traffic=traffic, widths=cfg["widths"],
                      roofline=roofline)
        if trace:
            reqs, failed, window_s = _traced_window(torch, dep, op, traffic, ctx, cards)
        else:
            reqs, failed, window_s = window(op, seconds)
        leaked = forbidden_modules()
        if leaked:
            raise RuntimeError(f"modules of JAX or the JAX package loaded: {leaked}")
        peaks = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    finally:
        dep.close()
        gc.unfreeze()
    ctx.requests, ctx.window_s = reqs, window_s

    t_check = time.perf_counter()
    compared = op.compare()
    check_s = time.perf_counter() - t_check
    limits = {k: v for k, v in compared.items() if isinstance(v, tuple)}
    correct = bool(reqs) and failed == 0 and all(v <= lim for v, lim in limits.values())
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in bench[kind]}
    metrics = {}
    for name in cell_metrics(bench, cell, kind):
        value = load_reader(root, name).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if cards else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": wl["chips"], "memory_peak_bytes": max(peaks.values(), default=0)}
    result = {"correct": correct, "attempted": len(reqs) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        # the seconds a card ran something, averaged over the cell's cards
        busy = [ctx.trace.busy_by_card[c] for c in cards]
        dev.update(busy_s=sum(busy) / len(busy), window_s=window_s)
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    notes = {"checked": {k: v for k, v in compared.items() if k not in limits},
             "setup_pieces_s": {label: at - prev for (label, at), prev in
                                zip(marks, [t_start] + [at for _, at in marks])},
             "latencies_s": ctx.latencies, "check_s": check_s,
             "memory_peak_bytes_by_card": peaks,
             "busy_s_by_card": ctx.trace.busy_by_card if ctx.trace else None}
    result["checked"] = notes["checked"]
    if control:
        result["control"] = {k: v[0] for k, v in op.compare(op.control()).items()
                             if isinstance(v, tuple)}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in limits.items()}
    return result, notes


def _traced_window(torch, dep, op, traffic: dict, ctx: Context, cards):
    """`trace_requests` requests under torch.profiler with the spans on:
    the deployment's hooks, each request, each compose2 graph replay by
    its lanes; per request the graph replays and the matmul's phases."""
    from cofhe_tpu_torch.ops import graphs

    spans = Spans(torch)
    for label, targets in dep.hooks().items():
        for obj, attr in targets:
            spans.wrap(obj, attr, label)
    orig_run = graphs.ComposeGraph.run

    def run(self, F1, F2):
        with torch.profiler.record_function(f"portbench.compose2@{self.shape[0][0]}"):
            return orig_run(self, F1, F2)

    graphs.ComposeGraph.run = run
    engines = dep.engines()
    before = [_replays(engines)]

    def on_request():
        now = _replays(engines)
        phases = getattr(engines[0], "last_matmul_phases", None)
        ctx.counters.append({"replays": now - before[0],
                             "matmul_phases": dict(phases) if phases else None})
        before[0] = now

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cards:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reqs, failed = [], 0
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t_win = time.perf_counter()
            for i in range(traffic["trace_requests"]):
                engines[0].__dict__.pop("last_matmul_phases", None)
                t0 = time.perf_counter()
                with spans.span("request"):
                    ok = workload.send(op, i)
                if ok:
                    reqs.append((t0, time.perf_counter()))
                    on_request()
                else:
                    failed += 1
            _sync(torch, cards)
            window_s = time.perf_counter() - t_win
    finally:
        graphs.ComposeGraph.run = orig_run
        spans.restore()
    ctx.spans = spans.intervals
    if cards:
        ctx.trace = DeviceTrace.from_profiler(prof, window_s, cards)
    return reqs, failed, window_s
