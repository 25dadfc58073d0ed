"""CUDA graphs of CG.compose2: the port's counterpart of the JAX engine's
jitted steps (cofhe_tpu/ops/engine.py `JaxEngine._jit_rows`,
`_add_kernel`, `_scal_kernel`, `_wnaf_bank_kernel`, `_wnaf_segment_kernel`,
`_matmul_kernel2`, `_combine_kernel`, `_chain_stack_kernel`,
`_phase2_kernel`).

The JAX package compiles each engine step, compose2 included, into one
device program whose loops stay on the device. The port's eager compose2
is a sequence of small torch kernels around the Hopper kernels; with KT
for the exact tail, REDCs that run on every lane and, in the opt-in NUCOMP
tail, K7 for the Lehmer walk, it reads no value on the host, so its
kernels are fixed, which a `torch.cuda.CUDAGraph` captures once and
replays as one launch. They form a DAG, not one sequence: compose2 forks
three chains that lie off its critical path (the second gcd's width-8
pipeline; t2 with its term of mu_red; m2, a1g and m2x2) onto the device's
two side streams (`side_streams`) and joins each where its result is
first read (`forms2._Dag`), so the captured graph holds parallel branches
and the card runs a branch's kernels beside the critical path. A capture
runs on a stream of high priority (`CRITICAL_PRIORITY`) and the side
streams take the lowest (`SIDE_PRIORITY`), which the graph keeps for each
kernel: where both have blocks to place, the card places the critical
path's first (at equal priority a branch slowed the critical path by as
much as it saved). The branches keep these stream rules: a side stream
first waits for what the caller's stream has queued; a branch's inputs
stay alive until its join; its outputs are marked as used by the caller's
stream (`record_stream`), so the allocator reuses them only after that
stream's last use; every branch is joined before compose2 returns, so a
capture ends with no side stream outside it, and a side stream's
allocations inside a capture come from the graph's pool. A stream that
joins a capture belongs to it until the capture ends, so the side streams
have a lock: every capture holds it from its start to its end, and every
fork while it enqueues, so no thread's eager compose2 enters another
thread's capture. On the CPU the chains run in line. A NUCOMP CG (`use_nucomp`)
is a CG object of its own, with its own graphs and memory pools. Every
caller of `CG.compose2` / `nudupl2` (the Yao ladder, the wNAF bank, the
matmul's chain, ladder and finalization, add, combine, the sharded paths)
takes the graph with no change of its own.

One `ComposeGraph` per (device, batch shape), held by the CG's
`ComposeGraphs` and built at first use:

* warm-up: one eager compose2 on a side stream, on the first
  call's operands, fills limb._CONST and builds the kernels (its
  launches count: they run);
* capture: the same compose2 on static input BForms, with this thread's
  launch keys recorded into the graph (cuda_group.capturing_launches),
  after a garbage collection and with the collector off (a graph freed
  mid-capture would invalidate it). A host sync or host-to-device copy
  inside compose2 fails the capture, and a failed capture raises:
  nothing falls back to eager;
* replay: copy F1 and F2 into the static inputs (nudupl2 passes one F
  twice), replay and return clones of the static outputs, since a caller
  may feed an output straight back in as the next input. A replay adds one
  to the graph's replays (its `cuda_group.GraphLaunches`, from which
  cuda_group.LAUNCHES counts the graph's kernels when read) and, while
  tracing is on, is a `graphs.replay` span (utils/trace.py) with the batch
  as `lanes`, the captured compose2's fork sites as `branches` and the
  stream it was queued on as `stream` (below), from the input copies to
  the clones enqueued.

The shared-exponent wNAF ladder (`nupow2.wnaf_segment`: one nudupl a
digit, then a compose with a bank slot or its inverse where the digit is
nonzero) keeps its state on the card instead: one `LadderGraphs` per
(device, batch shape, bank slots), in the same `ComposeGraphs` (its
`ladders`, apart from `graphs`), built at first use with the same
warm-up (from the bank's first slot), collection and capture rules. Its static buffers hold the
running form `r`, the bank with the inverses' signs beside it and a plan
(a counter, then the bank row of each nonzero digit in order), and two
graphs step `r` in place: S, `r <- nudupl2(r)`, and SC, `r <- compose2(
nudupl2(r), bank[plan[counter]])` with the counter advanced. Neither
depends on the exponent. A call loads `r` and the bank, uploads the plan
(again every `PLAN_ROWS` nonzero digits), launches S or SC for each
digit, which the host knows, and returns a clone of `r`: one launch a
digit, with no copies around it. On the CPU `wnaf_segment` runs the same
step bodies eagerly (`LadderSteps`), on a state made afresh each call, so
the CPU tests drive the card's ladder code. A ladder call adds to its
graphs' replays (`LadderGraphs.steps` is their sum; cuda_group.LAUNCHES
counts their kernels) and, while tracing is on, is one `graphs.ladder`
span with `lanes`, `steps` (its digits) and `branches` (the CG's compose2
fork sites, `CG.branches`), on a card also `stream` and `beside` (below).

Streams. Every TorchEngine on a card owns one stream (`owned_stream`,
made at the engine's construction and held by its CG's ComposeGraphs as
`stream`), and everything the engine enqueues runs there: the uploads of
forms, compose2 replays, the wNAF bank, the ladder's step graphs and the
read-back to the host, which synchronizes that stream alone. So the
network's nodes, each with its own engine in one process, queue their
part-decryptions on streams of their own and the card runs them side by
side; on one shared stream the card would run one node's ladder after the
other's. An engine's stream is non-blocking (it
never waits for the legacy default stream), of priority 0, and made by
the driver outside torch's pool of streams, so that no other live
engine's stream, no side stream, no capture's stream and no stream a
library draws from the pool is it; when its CG is collected it goes back
to the device's free list for the next engine, and none is destroyed.
The captured graphs keep their own priorities per kernel. What waits on
what: the engine's stream waits once, at construction, for what the
constructor queued on the caller's stream (the CG's constants); a
capture's stream waits for the engine's stream, and the engine's stream
for the capture; the side streams wait for the stream that forks and are
joined by it (above). The engine's ops take forms on the host and return
forms on the host, so nothing of a caller's stream is read. A caller on
another stream that holds the engine's CG (a tool, a test) is moved onto
the CG's stream for each replay and ladder call: the CG's stream waits for
the caller's, the caller's for the result, whose tensors are marked as
used by the caller's stream. So the static buffers of a CG's graphs have
exactly one stream, the CG's: one lock a CG orders builds and compose2
replays, and one lock a LadderGraphs its ladder calls, from loading the
state to the result's clone, and both are released once the work and its
clones are enqueued on that stream. A CG built without an engine has no
stream of its own and runs on its callers' current stream; its buffers
are shared safely only while those callers use one stream. Captures use
thread-local capture mode on a stream of their own, so a node runtime's
other threads keep using the card meanwhile.

A ladder call on a card registers its stream and, when enqueued, the event
of its last step with the device's ladder registry (`ladders_on`): its
`graphs.ladder` span carries the stream (`stream`, the stream's handle)
and how many other streams' ladders were still queued or running on the
card when it started (`beside`, from a non-blocking query of each one's
event). `graphs.replay` spans carry `stream` too. On the CPU the spans
carry neither.

Each graph keeps its private memory pool for the life of its CG, one per
batch size seen; nothing releases them.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
import weakref

import torch

from ..utils import trace
from . import cuda_group
from .forms import BForm, bform_neg

I32 = torch.int32
# nonzero digits a plan upload holds; a longer exponent uploads again
PLAN_ROWS = 1024
# the priorities of compose2's streams (lower is higher; 0 is the lowest):
# a capture's, which the graph keeps for compose2's critical path, and the
# side streams' of its branches. Where a branch and the critical path both
# have blocks to place, the card places the critical path's first.
CRITICAL_PRIORITY, SIDE_PRIORITY = -1, 0
# compose2's side streams by device: (lock, stream, stream)
_SIDES: dict = {}
_SIDES_MADE = threading.Lock()


def side_streams(dev: torch.device) -> tuple:
    """(lock, stream, stream): compose2's two side streams on CUDA device
    `dev` (a tensor's, with its index), shared by every CG there, and their
    lock (module docstring); made at the first compose2 on the device, an
    eager call (a graph's warm-up comes before its capture)."""
    with _SIDES_MADE:
        sides = _SIDES.get(dev)
        if sides is None:
            sides = _SIDES[dev] = (threading.RLock(),
                                   torch.cuda.Stream(dev, priority=SIDE_PRIORITY),
                                   torch.cuda.Stream(dev, priority=SIDE_PRIORITY))
    return sides


# engines' streams by device that no live CG holds: the next engine's
_FREE_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()
_CU_STREAM_NON_BLOCKING = 1


def _check_cu(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def _driver_stream(dev: torch.device) -> int:
    """The handle of a new non-blocking stream of priority 0 on CUDA device
    `dev` in its primary context (the one torch's runtime uses), made by the
    driver (`cuStreamCreateWithPriority`), outside torch's pool. The primary
    context stays retained: the stream is never destroyed."""
    cu = ctypes.CDLL("libcuda.so.1")
    cudev, ctx, stream = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_void_p()
    _check_cu(cu.cuInit(0), "cuInit")
    _check_cu(cu.cuDeviceGet(ctypes.byref(cudev), dev.index), "cuDeviceGet")
    _check_cu(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), cudev),
              "cuDevicePrimaryCtxRetain")
    _check_cu(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
    try:
        _check_cu(cu.cuStreamCreateWithPriority(ctypes.byref(stream),
                                                _CU_STREAM_NON_BLOCKING, 0),
                  "cuStreamCreateWithPriority")
    finally:
        cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
    return stream.value


def owned_stream(owner, dev: torch.device) -> torch.cuda.ExternalStream:
    """A stream of `owner`'s own on CUDA device `dev` (with its index): an
    engine's, owned by its CG (module docstring). It is taken from the
    device's free list, or made by the driver; it goes back to the list when
    `owner` is collected, so no two live owners share one."""
    with _STREAMS_LOCK:
        free = _FREE_STREAMS.setdefault(dev, [])
        stream = (free.pop() if free else
                  torch.cuda.ExternalStream(_driver_stream(dev), device=dev))
    weakref.finalize(owner, _release_stream, dev, stream)
    return stream


def _release_stream(dev: torch.device, stream) -> None:
    with _STREAMS_LOCK:
        _FREE_STREAMS.setdefault(dev, []).append(stream)


class LadderRegistry:
    """The ladders of one device by stream: the event of each stream's last
    ladder step, or None while that stream's ladder is being enqueued."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last: dict = {}

    def begin(self, stream_id: int) -> int:
        """Registers a ladder of `stream_id`; returns how many other
        streams' ladders are still being enqueued, or queued or running on
        the card (their event's non-blocking `query()` is false)."""
        with self._lock:
            beside = sum(1 for sid, done in self._last.items() if sid != stream_id
                         and (done is None or not done.query()))
            self._last[stream_id] = None
        return beside

    def end(self, stream_id: int, done) -> None:
        """The ladder of `stream_id` is enqueued up to `done`, its last
        step's event; None (the ladder raised) drops the stream."""
        with self._lock:
            if done is None:
                self._last.pop(stream_id, None)
            else:
                self._last[stream_id] = done


_LADDERS: dict = {}


def ladders_on(dev: torch.device) -> LadderRegistry:
    """The ladder registry of CUDA device `dev`."""
    with _STREAMS_LOCK:
        reg = _LADDERS.get(dev)
        if reg is None:
            reg = _LADDERS[dev] = LadderRegistry()
    return reg


def _shape(F: BForm):
    return tuple(F.a.shape), tuple(F.b_sign.shape)


def _empty_bform(lead: tuple, L: int, dev) -> BForm:
    return BForm(torch.empty(lead + (L,), dtype=I32, device=dev),
                 torch.empty(lead, dtype=I32, device=dev),
                 torch.empty(lead + (L,), dtype=I32, device=dev),
                 torch.empty(lead + (L,), dtype=I32, device=dev))


class _Captured:
    """`body` as a CUDA graph on its device: warmed up once eagerly on a
    side stream, then captured there (module docstring); `out` is what the
    captured call returned, `launches` the graph's launch record (owned by
    `owner`), `warmup_s`, `capture_s` and the memory reserved around the
    capture."""

    def __init__(self, owner, dev, body, what: str):
        cur = torch.cuda.current_stream(dev)
        # compose2's critical path at CRITICAL_PRIORITY
        stream = torch.cuda.Stream(dev, priority=CRITICAL_PRIORITY)
        stream.wait_stream(cur)
        t = time.perf_counter()
        with torch.cuda.stream(stream):
            body()
        stream.synchronize()
        self.warmup_s = time.perf_counter() - t
        self.reserved_before = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        keys: list = []
        t = time.perf_counter()
        # a graph that the cyclic collector frees mid-capture (another
        # CG's) would release its pool: a call that invalidates the
        # capture. Collect first, and not during it.
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with (torch.cuda.stream(stream), cuda_group.capturing_launches(keys),
                  side_streams(dev)[0]):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = body()
                except BaseException as e:
                    try:
                        self.graph.capture_end()
                    except Exception:  # the capture is already invalid
                        pass
                    raise RuntimeError(f"capturing {what} on {dev} failed: {e}") from e
                self.graph.capture_end()
        finally:
            if was_enabled:
                gc.enable()
        cur.wait_stream(stream)
        self.capture_s = time.perf_counter() - t
        self.reserved_after = torch.cuda.memory_reserved(dev)
        self.keys = tuple(keys)
        self.launches = cuda_group.graph_launches(owner, self.keys)


class ComposeGraph:
    """compose2 captured at one (device, batch shape) of a CG."""

    def __init__(self, cg, F1: BForm, F2: BForm):
        dev = F1.a.device
        if dev.type != "cuda":
            raise ValueError(f"ComposeGraph captures CUDA graphs: the inputs lie "
                             f"on {dev}; on the CPU compose2 runs eagerly")
        self.shape = _shape(F1)
        B, L = self.shape[0]
        self.device = dev
        with torch.cuda.device(dev), torch.inference_mode(False), torch.no_grad():
            self.in1, self.in2 = _empty_bform((B,), L, dev), _empty_bform((B,), L, dev)
            self._load(F1, F2)
            cap = _Captured(self, dev, lambda: cg.compose2_eager(self.in1, self.in2),
                            f"compose2 at batch {B}")
        self.graph, self.out, self.keys, self.launches = (cap.graph, cap.out, cap.keys,
                                                          cap.launches)
        # the captured compose2's fork sites (forms2._Dag)
        self.branches = cg.branches
        self.warmup_s, self.capture_s = cap.warmup_s, cap.capture_s
        self.reserved_before, self.reserved_after = cap.reserved_before, cap.reserved_after
        self._span_attrs = {"lanes": B, "branches": self.branches}

    @property
    def replays(self) -> int:
        return self.launches.replays

    @property
    def pool_bytes(self) -> int:
        """Device memory the capture reserved (its private pool)."""
        return self.reserved_after - self.reserved_before

    def _load(self, F1: BForm, F2: BForm) -> None:
        for F in (F1, F2):
            if _shape(F) != self.shape or F.a.device != self.device:
                raise ValueError(f"ComposeGraph at {self.shape} on {self.device} "
                                 f"got a BForm of {_shape(F)} on {F.a.device}")
        for dst, src in zip(self.in1 + self.in2, F1 + F2):
            dst.copy_(src)

    def run(self, F1: BForm, F2: BForm) -> BForm:
        """compose2(F1, F2) by one replay, as fresh tensors."""
        with trace.span("graphs.replay", self._span_attrs) as sp, \
                torch.cuda.device(self.device):
            if sp:
                sp.attrs = {**self._span_attrs, "stream":
                            torch.cuda.current_stream(self.device).cuda_stream}
            self._load(F1, F2)
            self.graph.replay()
            out = BForm(*(x.clone() for x in self.out))
        self.launches.replays += 1
        return out


def wnaf_plan(sched, nslots: int) -> list[int]:
    """The plan of a wNAF digit stream: for each nonzero digit d, in order,
    its row of the ladder's bank, (|d| - 1) / 2 for d > 0 and that plus
    `nslots` (the slot's inverse) for d < 0."""
    rows = []
    for d in sched:
        if d:
            slot = (abs(d) - 1) // 2
            if not (d & 1 and slot < nslots):
                raise ValueError(f"wNAF digit {d} is not an odd digit of a "
                                 f"{nslots}-slot bank")
            rows.append(slot + nslots if d < 0 else slot)
    return rows


class LadderSteps:
    """The wNAF ladder's state at one (device, batch shape, bank slots) of
    a CG, and its two steps on it (module docstring): `r`, the running
    form; `bank`, the S slots, with the inverses' signs in rows S..2S-1 of
    `bank.b_sign`; `plan`, the counter then at most PLAN_ROWS bank rows.
    `step_s` and `step_sc` launch the steps: here they run eagerly (the
    CPU's route, and the bodies every capture runs); LadderGraphs replays
    their captures."""

    def __init__(self, cg, bank: BForm, r: BForm):
        self.cg = cg
        self.shape = (tuple(bank.a.shape), _shape(r))
        S, B, L = bank.a.shape
        dev = self.device = r.a.device
        self.nslots = S
        self.r = _empty_bform((B,), L, dev)
        self.bank = BForm(torch.empty((S, B, L), dtype=I32, device=dev),
                          torch.empty((2 * S, B), dtype=I32, device=dev),
                          torch.empty((S, B, L), dtype=I32, device=dev),
                          torch.empty((S, B, L), dtype=I32, device=dev))
        self.plan = torch.zeros(1 + PLAN_ROWS, dtype=I32, device=dev)
        self.step_s, self.step_sc = self.square, self.square_mul

    def _load(self, bank: BForm, r: BForm) -> None:
        if (tuple(bank.a.shape), _shape(r)) != self.shape or r.a.device != self.device:
            raise ValueError(f"ladder at {self.shape} on {self.device} got a bank "
                             f"of {tuple(bank.a.shape)} and r of {_shape(r)} on "
                             f"{r.a.device}")
        for dst, src in zip(self.r, r):
            dst.copy_(src)
        S = self.nslots
        for dst, src in zip(self.bank, bank):
            dst[:S].copy_(src)
        self.bank.b_sign[S:].copy_(bform_neg(bank).b_sign)

    def _upload(self, rows: list) -> None:
        """The counter, 0, then `rows`, stream-ordered after what was queued."""
        host = torch.tensor([0] + rows, dtype=I32, pin_memory=self.plan.is_cuda)
        self.plan[:len(host)].copy_(host, non_blocking=True)

    def square(self) -> None:
        """S: r <- nudupl2(r)."""
        self._set_r(self.cg.compose2_eager(self.r, self.r))

    def square_mul(self) -> None:
        """SC: r <- compose2(nudupl2(r), bank row plan[1 + counter]); the
        counter advances. Reads nothing on the host."""
        counter = self.plan[:1]
        row = self.plan.index_select(0, counter + 1)
        slot = row.remainder(self.nslots)
        t = BForm(self.bank.a.index_select(0, slot)[0],
                  self.bank.b_sign.index_select(0, row)[0],
                  self.bank.b.index_select(0, slot)[0],
                  self.bank.c.index_select(0, slot)[0])
        counter.add_(1)
        sq = self.cg.compose2_eager(self.r, self.r)
        self._set_r(self.cg.compose2_eager(sq, t))

    def _set_r(self, out: BForm) -> None:
        for dst, src in zip(self.r, out):
            dst.copy_(src)

    def run(self, bank: BForm, r: BForm, sched, attrs: dict | None = None) -> BForm:
        """wnaf_segment(cg, bank, r, sched) on this state, as fresh tensors;
        `attrs` join the span's."""
        rows = wnaf_plan(sched, self.nslots)
        step_s, step_sc = self.step_s, self.step_sc
        with trace.span("graphs.ladder", {"lanes": self.r.a.shape[0], "steps": len(sched),
                                          "branches": self.cg.branches, **(attrs or {})}):
            self._load(bank, r)
            at = 0
            for d in sched:
                if d:
                    if at % PLAN_ROWS == 0:
                        self._upload(rows[at:at + PLAN_ROWS])
                    at += 1
                    step_sc()
                else:
                    step_s()
            return BForm(*(x.clone() for x in self.r))


class LadderGraphs(LadderSteps):
    """The wNAF ladder's two steps captured at one (device, batch shape,
    bank slots) of a CG; `steps` counts their launches."""

    def __init__(self, cg, bank: BForm, r: BForm):
        dev = r.a.device
        if dev.type != "cuda":
            raise ValueError(f"LadderGraphs captures CUDA graphs: the ladder lies "
                             f"on {dev}; on the CPU it runs eagerly")
        B = r.a.shape[0]
        with torch.cuda.device(dev), torch.inference_mode(False), torch.no_grad():
            super().__init__(cg, bank, r)
            # the warm-ups step from the bank's first slot (the call's base),
            # not from the caller's r (the decrypt's is the identity), so the
            # first eager operands at this batch, which chip_smoke.py
            # records, are a ladder's own
            self._load(bank, BForm(*(x[0] for x in bank)))
            self._s = _Captured(self, dev, self.square, f"the ladder's square at batch {B}")
            self._sc = _Captured(self, dev, self.square_mul,
                                 f"the ladder's square and multiply at batch {B}")
        self.step_s, self.step_sc = self._s.graph.replay, self._sc.graph.replay
        self._lock = threading.Lock()

    @property
    def steps(self) -> int:
        return self._s.launches.replays + self._sc.launches.replays

    @property
    def launches(self) -> tuple:
        """The launch records of S and SC."""
        return self._s.launches, self._sc.launches

    def run(self, bank: BForm, r: BForm, sched) -> BForm:
        with self._lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            sid = stream.cuda_stream
            reg = ladders_on(self.device)
            beside, done = reg.begin(sid), None
            try:
                out = super().run(bank, r, sched, {"stream": sid, "beside": beside})
                done = stream.record_event()
            finally:
                reg.end(sid, done)
            nonzero = sum(1 for d in sched if d)
            self._s.launches.replays += len(sched) - nonzero
            self._sc.launches.replays += nonzero
        return out


class ComposeGraphs:
    """A CG's graphs, built at first use: `graphs` maps each (device, batch
    shape) to its ComposeGraph, `ladders` each (device, bank shape) to its
    LadderGraphs. `stream` is the CG's stream (its engine's; None for a CG
    without an engine): every replay and ladder call runs there (module
    docstring)."""

    def __init__(self, cg):
        self.cg = cg
        self.graphs: dict = {}
        self.ladders: dict = {}
        self.stream = None
        self._lock = threading.Lock()

    def _on_stream(self, fn, *args) -> BForm:
        """fn(*args) on the CG's stream: in place where the caller is on it
        (the engine's ops), else after a wait for the caller's stream, which
        then waits for the result and is marked as its user."""
        s = self.stream
        if s is None:
            return fn(*args)
        cur = torch.cuda.current_stream(s.device)
        if cur.cuda_stream == s.cuda_stream:
            return fn(*args)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = fn(*args)
        cur.wait_stream(s)
        for x in out:
            x.record_stream(cur)
        return out

    def run(self, F1: BForm, F2: BForm) -> BForm:
        return self._on_stream(self._replay, F1, F2)

    def _replay(self, F1: BForm, F2: BForm) -> BForm:
        key = (F1.a.device,) + _shape(F1)[0]
        with self._lock:
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = ComposeGraph(self.cg, F1, F2)
            return g.run(F1, F2)

    def run_ladder(self, bank: BForm, r: BForm, sched) -> BForm:
        """wnaf_segment(cg, bank, r, sched): on a CUDA device by the
        ladder's step graphs, held for later calls; elsewhere by its steps
        run eagerly on a fresh state, which no other call shares (several
        nodes of a CPU network run in one process)."""
        if r.a.device.type != "cuda":
            return LadderSteps(self.cg, bank, r).run(bank, r, sched)
        return self._on_stream(self._ladder, bank, r, sched)

    def _ladder(self, bank: BForm, r: BForm, sched) -> BForm:
        key = (r.a.device,) + tuple(bank.a.shape)
        with self._lock:
            lg = self.ladders.get(key)
            if lg is None:
                lg = self.ladders[key] = LadderGraphs(self.cg, bank, r)
        return lg.run(bank, r, sched)
