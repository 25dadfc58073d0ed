"""Batched exponentiation helpers on the v2 compose (torch port of
cofhe_tpu/ops/nupow2.py).

* signed radix-2^w recoding of per-element exponents (host side; the
  matmul's Yao ladder reads these digits as job data);
* the elementwise signed-digit Yao ladder of scal_batch (`nupow_yao2`): a
  bank of 2^(w-1)+1 slots updated by a masked select, one compose2 and w
  nudupl2 a window, then the suffix-product finalization;
* the shared-exponent wNAF ladder of part_decrypt / decrypt: an odd-power
  bank, then one nudupl per digit and one compose per nonzero digit
  (`make_wnaf_bank` + `wnaf_segment`, or both in one call,
  `nupow_shared_wnaf2`). The digit schedule is host data, so the
  per-digit branch is a Python `if` (on the card, the choice of one of
  two captured step graphs).

Every step ends on reduced forms, so results equal core.qfi.nupow.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limb as lb
from .forms import BForm, bform_neg, bform_select
from .forms2 import CG


def identity_bform2(cg: CG, batch: int) -> BForm:
    L = cg.L
    dev = cg.device
    c = lb.resize(cg.delta4, L)[None, :].expand(batch, L).contiguous()
    return BForm(lb.one_limbs((batch,), L, dev),
                 torch.zeros(batch, dtype=torch.int32, device=dev),
                 torch.zeros(batch, L, dtype=torch.int32, device=dev), c)


def signed_windows(e: int, w: int, nwind: int) -> list[int]:
    """Little-endian signed radix-2^w digits: e = sum d_t * 2^(w t) with
    d_t in [-2^(w-1), 2^(w-1))."""
    if e < 0:
        raise ValueError("exponent must be non-negative")
    half = 1 << (w - 1)
    out = []
    for _ in range(nwind):
        d = e & ((1 << w) - 1)
        if d >= half:
            d -= 1 << w
        e = (e - d) >> w
        out.append(d)
    if e != 0:
        raise ValueError("nwind too small for exponent")
    return out


def nwind_for_bits(bits: int, w: int) -> int:
    """Window count covering `bits`-bit exponents incl. the recode carry."""
    return (bits + w) // w


def nupow_yao2(cg: CG, base: BForm, digits, w: int = 4) -> BForm:
    """base[i] ^ e_i for host-recoded signed digits.

    base:   (B, L) reduced forms.
    digits: (nwind, B) integers in [-2^(w-1), 2^(w-1)), from signed_windows.

    Window t composes chain = base^(2^(w t)) (inverted for a negative
    digit) into bank slot |d|; a digit-0 lane composes into slot 0, which
    the finalization never reads, so every lane runs the same steps. Then
    R = prod_{v=1}^{half} bank[v]^v by suffix products: T_v = bank[half]
    * ... * bank[v], R accumulates T_v.
    """
    dev = cg.device
    digits = torch.as_tensor(np.asarray(digits, dtype=np.int64), device=dev)
    nwind, B = digits.shape
    if base.a.shape[0] != B:
        raise ValueError(f"base batch {base.a.shape[0]} != digit lanes {B}")
    half = 1 << (w - 1)
    S = half + 1
    ident = identity_bform2(cg, B)
    bank = BForm(*(x[None].expand((S,) + x.shape).clone() for x in ident))
    slots = torch.arange(S, device=dev)[:, None]
    lanes = torch.arange(B, device=dev)
    chain = base
    for t in range(nwind):
        d = digits[t]
        slot = d.abs()
        term = bform_select(d < 0, bform_neg(chain), chain)
        comp = cg.compose2(BForm(*(x[slot, lanes] for x in bank)), term)
        bank = bform_select(slots == slot[None, :],  # (S, B)
                            BForm(*(x[None] for x in comp)), bank)
        if t + 1 < nwind:  # the last window's doublings are never read
            for _ in range(w):
                chain = cg.nudupl2(chain)

    def slot_of(v):
        return BForm(*(x[v] for x in bank))

    T = R = slot_of(half)
    for v in range(half - 1, 0, -1):
        T = cg.compose2(T, slot_of(v))
        R = cg.compose2(R, T)
    return R


def wnaf_digits(e: int, w: int) -> list[int]:
    """MSB-first wNAF digit stream (host side); nonzero digits odd in
    (-2^(w-1), 2^(w-1)). Density ~1/(w+1)."""
    if e < 0:
        raise ValueError("exponent must be non-negative")
    digits = []
    while e > 0:
        if e & 1:
            d = e & ((1 << w) - 1)
            if d >= (1 << (w - 1)):
                d -= 1 << w
            e -= d
        else:
            d = 0
        digits.append(d)
        e >>= 1
    return digits[::-1] or [0]


def make_wnaf_bank(cg: CG, base: BForm, w: int = 5) -> BForm:
    """Odd-power table bank[i] = base^(2i+1), (nslots, batch, L)."""
    nslots = 1 << (w - 2)
    sq = cg.nudupl2(base)
    tab = [base]
    for _ in range(nslots - 1):
        tab.append(cg.compose2(tab[-1], sq))
    return BForm(*(torch.stack([getattr(t, f) for t in tab])
                   for f in BForm._fields))


def wnaf_segment(cg: CG, bank: BForm, r: BForm, sched) -> BForm:
    """r <- r^(2^len(sched)) * prod(bank digits): one nudupl per digit,
    then a compose with bank[(|d|-1)/2] (inverted for d < 0) when d != 0,
    as the ladder's two steps on state of its own (ops/graphs.py
    `LadderSteps`): on a CUDA device one launch of a captured step a digit
    (`LadderGraphs`), on the CPU the steps run eagerly."""
    return cg.compose_graphs.run_ladder(bank, r, sched)


def nupow_shared_wnaf2(cg: CG, base: BForm, sched, w: int = 5) -> BForm:
    """base^e for a shared exponent known on the host: the odd-power bank
    of `make_wnaf_bank`, then `wnaf_segment` from the identity over the
    whole wNAF digit stream `sched` (wnaf_digits' MSB-first digits; a
    zero-padded front, as the JAX function's length buckets have, only
    squares the identity). The reductions take the grouped rho loop (K3 on
    the card): the JAX function's grouped=False pin works around a TPU
    scheduling fault, and reduced forms are unique."""
    sched = [int(d) for d in np.asarray(sched).reshape(-1)]
    bank = make_wnaf_bank(cg, base, w)
    return wnaf_segment(cg, bank, identity_bform2(cg, base.a.shape[0]), sched)
