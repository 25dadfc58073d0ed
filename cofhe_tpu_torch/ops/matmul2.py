"""Homomorphic scal-matmul as a gather -> compose -> scatter job stream
(torch port of cofhe_tpu/ops/matmul2.py).

ct(n, m) x pt(m, p) runs in three phases over one compose:

  chain   (nudupl, 2*n*m cell lanes)  - the doubling chain of every cell,
                                        kept at every w-th step;
  ladder  (compose, 2*n*m*p lanes)    - a pool machine: each job gathers two
                                        row sets from a form pool, composes
                                        them and scatters the result back.
                                        Jobs: one Yao-ladder bank update per
                                        window, then the m-contraction tree
                                        applied per bank slot;
  phase 2 (compose, 2*n*p lanes)      - Yao finalization of the contracted
                                        bank and the Enc(0) fold.

The plan (row map and job arrays) is numpy and identical to the JAX
package's. Pools are updated in place (`index_put_`); padding jobs write only
the dump row 1, so duplicate scatter indices never touch a live row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .forms import BForm, bform_neg, bform_select
from .forms2 import CG
from .nupow2 import identity_bform2


def _gather(bf: BForm, idx) -> BForm:
    return BForm(bf.a[idx], bf.b_sign[idx], bf.b[idx], bf.c[idx])


def _scatter(bf: BForm, idx, val: BForm) -> None:
    for f in BForm._fields:
        getattr(bf, f).index_put_((idx,), getattr(val, f))


def _tree_concat(bfs) -> BForm:
    return BForm(*(torch.cat([getattr(b, f) for b in bfs], dim=0)
                   for f in BForm._fields))


class MatmulPlan:
    """Static layout + job templates for one (rows2, m, p, nwind, w) shape.
    `rows2` counts the stacked (c1, c2) ciphertext rows (2*nr).

    Pool-B row map: [0]=identity  [1]=scatter dump  [CH:]=doubling-chain
    stack (nwind x Bb)  [BK:]=bank (S x B).
    Pool-C row map: [0]=identity  [1]=dump  [ZO:]=Enc(0) rows (rows2*p)
    [SB:]=contracted bank slots 1..S-1  [T:], [R:]=finalization state.
    """

    def __init__(self, rows2: int, m: int, p: int, nwind: int, w: int):
        self.rows2, self.m, self.p, self.nwind, self.w = rows2, m, p, nwind, w
        self.half = 1 << (w - 1)
        self.S = self.half + 1
        self.Bb = rows2 * m
        self.B = rows2 * m * p
        self.Bo = rows2 * p
        B, S = self.B, self.S
        self.CH = 2
        self.BK = self.CH + nwind * self.Bb
        self.NP = self.BK + S * B

        lane = np.arange(B, dtype=np.int32)
        # exponent lane r = ((hi*m + j)*p + kk); its base cell = hi*m + j
        self.base_map = lane // p
        self.lane = lane

        # ---- ladder contraction steps: per-slot binary tree over j
        steps = []
        hi = np.arange(rows2, dtype=np.int32)
        kk = np.arange(p, dtype=np.int32)
        v = np.arange(1, S, dtype=np.int32)
        l = 0
        while (1 << l) < m:
            stride = 1 << l
            j0 = np.arange(0, m - stride, 2 * stride, dtype=np.int32)
            if j0.size:
                ia = (self.BK + v[:, None, None, None] * B
                      + (hi[None, :, None, None] * m
                         + j0[None, None, :, None]) * p
                      + kk[None, None, None, :]).ravel()
                ib = (self.BK + v[:, None, None, None] * B
                      + (hi[None, :, None, None] * m
                         + (j0[None, None, :, None] + stride)) * p
                      + kk[None, None, None, :]).ravel()
                steps.extend(self._pack(ia, ib, ia))
            l += 1
        self.contract_steps = steps  # list of (4, B) int32

        # ---- phase-2 jobs: Yao finalization + Enc(0) fold
        Bo = self.Bo
        self.ZO = 2
        self.SB = self.ZO + Bo
        self.Tr = self.SB + (S - 1) * Bo
        self.Rr = self.Tr + Bo
        self.NPC = self.Rr + Bo
        laneo = np.arange(Bo, dtype=np.int32)

        def sb(vv):  # rows of contracted bank slot vv (1-indexed)
            return self.SB + (vv - 1) * Bo + laneo

        jc = []
        zero4 = np.zeros(Bo, dtype=np.int32)
        T, R = self.Tr + laneo, self.Rr + laneo
        if self.half == 1:
            jc.append(np.stack([sb(1), self.ZO + laneo, zero4, R]))
        else:
            for vv in range(self.half - 1, 0, -1):
                first = vv == self.half - 1
                jc.append(np.stack([sb(self.half) if first else T,
                                    sb(vv), zero4, T]))
                jc.append(np.stack([sb(self.half) if first else R,
                                    T, zero4, R]))
            jc.append(np.stack([R, self.ZO + laneo, zero4, R]))
        self.fin_jobs = np.stack(jc).astype(np.int32)  # (nstepsC, 4, Bo)

        self.out_rows = (self.Rr + laneo).astype(np.int32)
        # contracted-bank gather rows out of pool B (slot-major)
        self.sb_rows = (self.BK + v[:, None] * B
                        + (hi[None, :] * m + 0) * p)[..., None] \
            + kk[None, None, :]
        self.sb_rows = self.sb_rows.reshape(-1).astype(np.int32)

    def _pack(self, ia, ib, io):
        """Pack flat lane lists into full-width (4, B) steps; pad with
        identity∘identity -> dump."""
        B = self.B
        cnt = ia.size
        nsteps = max(1, (cnt + B - 1) // B)
        pad = nsteps * B - cnt
        z = np.zeros(pad, dtype=np.int32)
        ia = np.concatenate([ia.astype(np.int32), z])
        ib = np.concatenate([ib.astype(np.int32), z])
        io = np.concatenate([io.astype(np.int32), z + 1])
        nb = np.zeros(nsteps * B, dtype=np.int32)
        return [np.stack([ia[s * B:(s + 1) * B], ib[s * B:(s + 1) * B],
                          nb[s * B:(s + 1) * B], io[s * B:(s + 1) * B]])
                for s in range(nsteps)]

    def jobs_b(self, digits: np.ndarray) -> np.ndarray:
        """Full ladder job array for one call. digits: (nwind, B) signed."""
        nwind, B = digits.shape
        if (nwind, B) != (self.nwind, self.B):
            raise ValueError(f"digits {digits.shape} do not fit the plan "
                             f"({self.nwind}, {self.B})")
        slot = np.abs(digits).astype(np.int32)
        ia = self.BK + slot * B + self.lane[None, :]
        ib = (self.CH + (np.arange(nwind, dtype=np.int32) * self.Bb)[:, None]
              + self.base_map[None, :])
        nb = (digits < 0).astype(np.int32)
        ladder = np.stack([ia, ib, nb, ia], axis=1)  # (nwind, 4, B)
        if self.contract_steps:
            return np.concatenate(
                [ladder, np.stack(self.contract_steps)], axis=0)
        return ladder


@functools.lru_cache(maxsize=16)
def get_plan(rows2: int, m: int, p: int, nwind: int, w: int) -> MatmulPlan:
    return MatmulPlan(rows2, m, p, nwind, w)


def _make_step(cg: CG):
    def step(pool: BForm, job: torch.Tensor) -> None:
        ia, ib, nb, io = job[0], job[1], job[2], job[3]
        A = _gather(pool, ia)
        Bv = _gather(pool, ib)
        Bv = bform_select(nb.bool(), bform_neg(Bv), Bv)
        _scatter(pool, io, cg.compose2(A, Bv))

    return step


def make_chain_stack(cg: CG, nwind: int, w: int):
    """cells -> doubling-chain stack (nwind, batch, ...) with
    chain_t = cells ^ (2^(w t))."""

    def fn(bf_cells: BForm) -> BForm:
        stack = [bf_cells]
        c = bf_cells
        for _ in range(nwind - 1):
            for _ in range(w):
                c = cg.nudupl2(c)
            stack.append(c)
        return BForm(*(torch.stack([getattr(s, f) for s in stack])
                       for f in BForm._fields))

    return fn


def make_chain(cg: CG, plan: MatmulPlan):
    """cells -> doubling-chain stack flattened to (nwind * Bb) rows, the
    ladder's pool layout."""
    stack_fn = make_chain_stack(cg, plan.nwind, plan.w)

    def fn(bf_cells: BForm) -> BForm:
        return BForm(*(x.reshape((plan.nwind * plan.Bb,) + x.shape[2:])
                       for x in stack_fn(bf_cells)))

    return fn


def make_ladder(cg: CG, plan: MatmulPlan):
    """chain stack (flattened to nwind*Bb rows) -> contracted bank: the pool
    machine (Yao ladder bank updates + per-slot m-contraction)."""
    step = _make_step(cg)

    def fn(chain: BForm, jobs_b: torch.Tensor) -> BForm:
        pool = _tree_concat([identity_bform2(cg, 2), chain,
                             identity_bform2(cg, plan.S * plan.B)])
        for job in jobs_b:
            step(pool, job)
        return _gather(pool, torch.as_tensor(plan.sb_rows, dtype=torch.long,
                                             device=cg.device))

    return fn


def make_phase2(cg: CG, plan: MatmulPlan):
    """Contracted bank -> result: Yao finalization + Enc(0) fold.
    fn(bf_smallbank, bf_zero) -> BForm of Bo rows [c1 x Bo/2, c2 x Bo/2]."""
    step = _make_step(cg)

    def fn(bf_smallbank: BForm, bf_zero: BForm) -> BForm:
        pool = _tree_concat([identity_bform2(cg, 2), bf_zero, bf_smallbank,
                             identity_bform2(cg, 2 * plan.Bo)])
        for job in torch.as_tensor(plan.fin_jobs, dtype=torch.long,
                                   device=cg.device):
            step(pool, job)
        return _gather(pool, torch.as_tensor(plan.out_rows, dtype=torch.long,
                                             device=cg.device))

    return fn


def make_phase1(cg: CG, plan: MatmulPlan):
    """cells -> contracted bank (chain, then ladder): the phase the sharded
    matmul runs on every rank before its tp gather.
    fn(bf_cells, jobs_b) -> BForm of (S-1)*Bo rows, slot-major: slot v's Bo
    rows hold prod_j bank[(hi, j, kk)][v] at (hi, kk).

    bf_cells: (Bb,) stacked [c1 of cell(hi=0..rows2/2-1, j)..., c2...];
    jobs_b:   (nsteps, 4, B) from plan.jobs_b(digits)."""
    chain_fn = make_chain(cg, plan)
    ladder_fn = make_ladder(cg, plan)

    def fn(bf_cells: BForm, jobs_b: torch.Tensor) -> BForm:
        return ladder_fn(chain_fn(bf_cells), jobs_b)

    return fn


def make_matmul_fn(cg: CG, plan: MatmulPlan):
    """One-device matmul: phase 1 then phase 2.
    fn(bf_cells, bf_zero, jobs_b) -> BForm of Bo result rows."""
    p1 = make_phase1(cg, plan)
    p2 = make_phase2(cg, plan)

    def fn(bf_cells: BForm, bf_zero: BForm, jobs_b: torch.Tensor) -> BForm:
        return p2(p1(bf_cells, jobs_b), bf_zero)

    return fn
