"""Multi-card execution over a (dp, tp) mesh of torch.distributed ranks
(torch port of cofhe_tpu/parallel/sharded.py).

The axes are the JAX package's:

  * dp - the ciphertext-row axis: the stacked (c1, c2) rows of a matmul
    are split across ranks; no collective until the result is gathered.
  * tp - the contraction axis m of ct(n, m) x pt(m, p): each rank ladders
    and contracts its j-slice into a per-slot Yao bank, the banks meet in
    an all_gather and a composition tree, and the finalization runs on the
    combined bank (contraction commutes with the Yao identity in an abelian
    group, ops/matmul2.py).
  * threshold - party i's lambda-signed partial decryptions on the rank at
    tp coordinate i, combined by an all_gather and the tree.

The run is SPMD: every rank calls with the same inputs and every rank
returns the full result (the JAX engine's `_fetch` gives every host the
whole array). Group composition is not an arithmetic sum, so reductions are
an all_gather plus ceil(log2 t) compose levels, never an all_reduce. Every
compose runs the kernels of CG.compose2 on the rank's own device.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from ..ops.forms import BForm, bform_select
from ..ops.forms2 import CG
from ..ops.matmul2 import MatmulPlan, make_phase1, make_phase2
from ..ops.nupow2 import identity_bform2

# gather_bform's calls and the bytes it received, summed over calls
GATHERS = {"calls": 0, "bytes": 0}


def mesh_shape(n: int, dp: int | None = None,
               tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) of a mesh over n ranks, as the JAX package's make_mesh
    factors n devices: tp the largest power of two at most sqrt(n)."""
    if dp is None and tp is None:
        tp = 1 << ((n.bit_length() - 1) // 2)
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp < 1 or tp < 1 or dp * tp > n:
        raise ValueError(f"a ({dp}, {tp}) mesh does not fit {n} ranks")
    return dp, tp


class Mesh:
    """A (dp, tp) grid over ranks 0 .. dp * tp - 1 of the process group,
    row-major (rank = d * tp + t), as the JAX package's
    Mesh(devices[:dp * tp].reshape(dp, tp), ("dp", "tp")). `device_mesh`
    is the torch DeviceMesh that holds the axis groups; it is None for a
    one-rank mesh without a process group."""

    axis_names = ("dp", "tp")

    def __init__(self, dp: int, tp: int, device_mesh=None):
        self.dp, self.tp, self.device_mesh = dp, tp, device_mesh

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def coordinate(self) -> tuple[int, int] | None:
        """(d, t) of this rank, or None for a rank outside the mesh."""
        if self.device_mesh is None:
            return (0, 0)
        c = self.device_mesh.get_coordinate()
        return None if c is None else (int(c[0]), int(c[1]))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def make_mesh(dp: int | None = None, tp: int | None = None) -> Mesh:
    """Mesh over the ranks of the process group (one rank without one);
    ranks past dp * tp are left out, as the JAX package leaves the devices
    past devices[:dp * tp]. Every rank of the group must call it."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    dp, tp = mesh_shape(world, dp, tp)
    if world == 1:
        return Mesh(dp, tp)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return Mesh(dp, tp, init_device_mesh(device_type, (dp, tp),
                                         mesh_dim_names=Mesh.axis_names))


def gather_bform(bf: BForm, group) -> BForm:
    """The (rows, ...) BForm of every rank of `group`, stacked in group-rank
    order into (group size, rows, ...): one all_gather of the four fields
    packed into one int32 row. A gloo group gathers through host tensors
    (the backend the group was built with decides, not a caught error);
    NCCL gathers on the card."""
    n = tdist.get_world_size(group)
    rows = bf.a.shape[0]
    parts = [bf.a.reshape(rows, -1), bf.b_sign.reshape(rows, 1),
             bf.b.reshape(rows, -1), bf.c.reshape(rows, -1)]
    packed = torch.cat(parts, dim=1)
    if tdist.get_backend(group) == "gloo":
        packed = packed.cpu()
    out = packed.new_empty((n * rows, packed.shape[1]))
    tdist.all_gather_into_tensor(out, packed, group=group)
    GATHERS["calls"] += 1
    GATHERS["bytes"] += out.numel() * out.element_size()
    out = out.to(bf.a.device).reshape(n, rows, -1)
    fields, at = [], 0
    for x, part in zip(bf, parts):
        w = part.shape[1]
        fields.append(out[:, :, at:at + w].reshape((n,) + x.shape))
        at += w
    return BForm(*fields)


def _scan_tree_compose(cg: CG, stacked: BForm, t: int) -> BForm:
    """Compose a (t, rows, ...) stack down to (rows, ...) in
    ceil(log2 t) levels (at least one) of fixed width (t_pad / 2) * rows,
    t_pad = 2^levels: the stack is identity-padded to t_pad parties, and a
    level's lanes past its live pairs compose identities and are masked
    back to their first operand."""
    rows = stacked.a.shape[1]
    levels = max(1, (t - 1).bit_length())
    t_pad = 1 << levels
    pad = identity_bform2(cg, (t_pad - t) * rows)
    cur = BForm(*(torch.cat([x.reshape((t * rows,) + x.shape[2:]), y])
                  for x, y in zip(stacked, pad)))
    width = (t_pad // 2) * rows
    lane = torch.arange(width, device=cur.a.device)
    i_t, r = lane // rows, lane % rows
    cnt = t_pad
    for _ in range(levels):
        live = i_t < cnt // 2
        ga = torch.where(live, 2 * i_t * rows + r, 0)
        gb = torch.where(live, (2 * i_t + 1) * rows + r, 0)
        A = BForm(*(x[ga] for x in cur))
        comp = bform_select(live, cg.compose2(A, BForm(*(x[gb] for x in cur))), A)
        cur = BForm(*(torch.cat([c, x[width:]]) for c, x in zip(comp, cur)))
        cnt //= 2
    return BForm(*(x[:rows] for x in cur))


def sharded_matmul(cg: CG, plan_loc: MatmulPlan, mesh: Mesh, cells: BForm,
                   zero: BForm, jobs: torch.Tensor) -> BForm:
    """The dp x tp sharded matmul on rank (d, t) (sharded_matmul_fn of the
    JAX package). plan_loc describes one shard: rows2_loc = 2n / dp stacked
    ct rows, m_loc = m / tp contraction columns, all p.

    cells: this shard's (rows2_loc * m_loc) cell block, (hi, j) row-major;
    zero:  the Enc(0) rows of dp block d, rows2_loc * p of them;
    jobs:  plan_loc.jobs_b of tp block t's digits.
    Returns the (2 n p) result rows of every dp block, in dp order.

    Phase 1 (chain, ladder, local contraction) runs locally, the contracted
    banks are gathered over tp and composed by the tree, phase 2
    (finalization and Enc(0)) runs locally, and the dp blocks are gathered.
    """
    sb = make_phase1(cg, plan_loc)(cells, jobs)
    if mesh.tp > 1:
        sb = _scan_tree_compose(cg, gather_bform(sb, mesh.group("tp")), mesh.tp)
    out = make_phase2(cg, plan_loc)(sb, zero)
    if mesh.dp > 1:
        out = BForm(*(x.reshape((-1,) + x.shape[2:])
                      for x in gather_bform(out, mesh.group("dp"))))
    return out


def sharded_threshold_combine(cg: CG, mesh: Mesh, d_loc: BForm) -> BForm:
    """Threshold combine over tp: this rank holds the lambda-signed partial
    decryptions of the party at its tp coordinate (the caller applies
    lambda = (1, -1, ..., -1)); every rank returns the composed d."""
    return _scan_tree_compose(cg, gather_bform(d_loc, mesh.group("tp")), mesh.tp)
