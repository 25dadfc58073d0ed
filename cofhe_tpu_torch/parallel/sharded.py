"""Composition tree over a stack of forms (torch port of
cofhe_tpu/parallel/sharded.py::_scan_tree_compose).

Group composition is not an arithmetic sum, so a reduction over parties
(the threshold combine, d = d_0 * d_1^-1 * ... once the caller has applied
lambda) composes pairs level by level. The mesh paths of the JAX module
(the dp x tp sharded matmul, the all_gather threshold combine, make_mesh)
are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.forms import BForm, bform_select
from ..ops.forms2 import CG
from ..ops.nupow2 import identity_bform2


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
