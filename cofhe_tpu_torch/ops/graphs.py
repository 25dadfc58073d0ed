"""CUDA graphs of CG.compose2: the port's counterpart of the JAX engine's
jitted steps (cofhe_tpu/ops/engine.py `JaxEngine._jit_rows`,
`_add_kernel`, `_scal_kernel`, `_wnaf_bank_kernel`, `_wnaf_segment_kernel`,
`_matmul_kernel2`, `_combine_kernel`, `_chain_stack_kernel`,
`_phase2_kernel`).

The JAX package compiles each engine step, compose2 included, into one
device program whose loops stay on the device. The port's eager compose2
is a sequence of small torch kernels around the Hopper kernels; with KT
for the exact tail, REDCs that run on every lane and, in the opt-in NUCOMP
tail, K7 for the Lehmer walk, it reads no value on the host, so it is one
fixed sequence of kernels, which a `torch.cuda.CUDAGraph` captures once
and replays as one launch. A NUCOMP CG (`use_nucomp`) is a CG object of
its own, with its own graphs and memory pools. Every caller of
`CG.compose2` / `nudupl2` (the wNAF and Yao ladders, the matmul's chain,
ladder and finalization, add, combine, the sharded paths) takes the graph
with no change of its own.

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
  as `lanes`, from the input copies to the clones enqueued.

Captures use thread-local capture mode on a stream of their own, so a
node runtime's other threads may keep using the card meanwhile; one lock
a CG orders builds and replays, which run on the caller's current stream.
The lock is released once a replay and its clones are enqueued, so the
static inputs and outputs are shared safely only while every caller of a
CG on one device uses one stream (the default stream: nothing in the port
sets another). A caller on a stream of its own could overwrite the static
inputs while another stream's replay still reads them.

Each graph keeps its private memory pool for the life of its CG, one per
batch size seen; nothing releases them.
"""

from __future__ import annotations

import gc
import threading
import time

import torch

from ..utils import trace
from . import cuda_group
from .forms import BForm

I32 = torch.int32


def _shape(F: BForm):
    return tuple(F.a.shape), tuple(F.b_sign.shape)


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
            def static() -> BForm:
                return BForm(torch.empty((B, L), dtype=I32, device=dev),
                             torch.empty((B,), dtype=I32, device=dev),
                             torch.empty((B, L), dtype=I32, device=dev),
                             torch.empty((B, L), dtype=I32, device=dev))

            self.in1, self.in2 = static(), static()
            self._load(F1, F2)
            cur = torch.cuda.current_stream(dev)
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(cur)
            t = time.perf_counter()
            with torch.cuda.stream(stream):
                cg.compose2_eager(self.in1, self.in2)
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
                with torch.cuda.stream(stream), cuda_group.capturing_launches(keys):
                    self.graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self.out = cg.compose2_eager(self.in1, self.in2)
                    except BaseException as e:
                        try:
                            self.graph.capture_end()
                        except Exception:  # the capture is already invalid
                            pass
                        raise RuntimeError(f"capturing compose2 at batch {B} on {dev} "
                                           f"failed: {e}") from e
                    self.graph.capture_end()
            finally:
                if was_enabled:
                    gc.enable()
            cur.wait_stream(stream)
            self.capture_s = time.perf_counter() - t
            self.reserved_after = torch.cuda.memory_reserved(dev)
        self.keys = tuple(keys)
        self.launches = cuda_group.graph_launches(self, self.keys)
        self._span_attrs = {"lanes": B}

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
        with trace.span("graphs.replay", self._span_attrs), \
                torch.cuda.device(self.device):
            self._load(F1, F2)
            self.graph.replay()
            out = BForm(*(x.clone() for x in self.out))
        self.launches.replays += 1
        return out


class ComposeGraphs:
    """A CG's compose2 graphs, one per (device, batch shape), built at
    first use; `graphs` maps each key to its ComposeGraph."""

    def __init__(self, cg):
        self.cg = cg
        self.graphs: dict = {}
        self._lock = threading.Lock()

    def run(self, F1: BForm, F2: BForm) -> BForm:
        key = (F1.a.device,) + _shape(F1)[0]
        with self._lock:
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = ComposeGraph(self.cg, F1, F2)
            return g.run(F1, F2)
