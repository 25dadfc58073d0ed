"""Multi-process control plane on torch.distributed (the port's copy of
cofhe_tpu/parallel/distributed.py).

One logical party may run on several cards: one process a card, all in one
torch.distributed process group, a (dp, tp) mesh over their ranks
(parallel/sharded.py), and the engine's sharded ops under it. The node
runtime (node/) stays the control plane between parties; this module wires
the cards of one party together.

Usage (per process of one logical party):

    from cofhe_tpu_torch.parallel import distributed as dist
    dist.init(coordinator="10.0.0.1:8476", num_processes=4, process_id=i)
    mesh = dist.global_mesh()
    cs = CryptoSystem(128, 128, device="cuda", mesh=mesh)

Single-process calls are no-ops, so the same node CLI flags work from one
card to many.
"""

from __future__ import annotations

import datetime
import logging

import torch
import torch.distributed as tdist

log = logging.getLogger("cofhe_tpu_torch.distributed")

_initialized = False        # init_process_group actually ran
# a rank that dies leaves the others in a collective: they raise after this
DEFAULT_TIMEOUT_S = 600.0


def init(coordinator: str | None = None, num_processes: int = 1,
         process_id: int = 0, backend: str | None = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (idempotent). A single-process call is a
    no-op that does NOT latch, so a later genuine multi-process init still
    runs; a multi-process call without a coordinator raises instead of
    silently running alone. The backend is "nccl" when the process sees a
    card (one card a rank), else "gloo"; ranks that share one card must
    pass backend="gloo", as NCCL refuses two ranks on one GPU. A CUDA rank
    first selects its local card, process_id modulo the cards it sees. A
    failed NCCL init raises; there is no retry on another backend."""
    global _initialized
    if num_processes <= 1:
        return
    if _initialized:
        return
    if coordinator is None:
        raise ValueError(
            f"multi-process init (num_processes={num_processes}) requires a "
            "coordinator address")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    log.info("torch.distributed: backend %s, process %d/%d, coordinator %s",
             backend, process_id, num_processes, coordinator)
    tdist.init_process_group(backend=backend,
                             init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id,
                             timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True


def global_mesh(dp: int | None = None, tp: int | None = None):
    """Mesh over all ranks of the process group (call after init())."""
    from .sharded import make_mesh

    return make_mesh(dp=dp, tp=tp)


def parse_flag(value: str) -> dict:
    """Parse the node CLI --distributed flag "coordinator:port,nproc,pid"."""
    parts = value.split(",")
    if len(parts) != 3:
        raise ValueError("--distributed expects coordinator:port,nproc,pid")
    return {"coordinator": parts[0], "num_processes": int(parts[1]),
            "process_id": int(parts[2])}
