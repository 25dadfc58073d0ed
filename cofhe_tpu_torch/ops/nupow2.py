"""Batched exponentiation helpers on the v2 compose (torch port of the
subset of cofhe_tpu/ops/nupow2.py that the matmul and decrypt paths use).

* signed radix-2^w recoding of per-element exponents (host side; the
  matmul's Yao ladder reads these digits as job data);
* the shared-exponent wNAF ladder of part_decrypt / decrypt: an odd-power
  bank, then one nudupl per digit and one compose per nonzero digit. The
  digit schedule is host data, so the per-digit branch is a Python `if`.

Every step ends on reduced forms, so results equal core.qfi.nupow.
"""

from __future__ import annotations

import torch

from . import limb as lb
from .forms import BForm, bform_neg
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
    then a compose with bank[(|d|-1)/2] (inverted for d < 0) when d != 0."""
    for d in sched:
        r = cg.nudupl2(r)
        if d != 0:
            idx = (abs(d) - 1) // 2
            t = BForm(bank.a[idx], bank.b_sign[idx], bank.b[idx], bank.c[idx])
            r = cg.compose2(r, bform_neg(t) if d < 0 else t)
    return r
