"""TorchEngine: the GPU compute path behind the port's CryptoSystem facade
(torch port of the slice of cofhe_tpu/ops/engine.py that the main path
runs).

Every batched op comes down to `CG.compose2` on int32 limb tensors:

  * compose_forms_batch - one batched composition (the batched encrypt);
  * scal_matmul         - ct(n, m) x pt(m, p) through the job stream of
                          ops/matmul2.py, in row chunks of about
                          `MATMUL_LANES` exponent lanes: per chunk the
                          doubling chain, the ladder + contraction, the Yao
                          finalization and the Enc(0) fold (their seconds,
                          summed over chunks, in `last_matmul_phases`);
  * part_decrypt_batch / decrypt_batch - the shared-exponent wNAF ladder
                          (the exponent is the host-known share or secret
                          key), then the host-side closed-form dlog.

Tensors live on the engine's device: "cuda" (the default of the facade)
runs the Hopper kernels, "cpu" runs their plain torch versions. Results
are bit-exact with the host oracle (unique reduced forms).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.cl_hsm2k import CipherText, CLHSM2k
from ..core.qfi import neg as qneg, nudupl as qnudupl, reduce_form
from ..tensor import Tensor
from . import limb as lb
from .forms import BForm, bform_from_forms, bform_to_forms
from .forms2 import CG, CGCtx
from .matmul2 import get_plan, make_chain_stack, make_ladder, make_phase2
from .nupow2 import (identity_bform2, make_wnaf_bank, nwind_for_bits,
                     signed_windows, wnaf_digits, wnaf_segment)

YAO_W = 4   # signed-digit window of the matmul's per-element exponents
WNAF_W = 5  # wNAF window of the shared decrypt exponent
# exponent lanes (2 * rows * m * p) per matmul chunk, and forms per batched
# compose or decrypt call: both bound the device memory of one call
MATMUL_LANES = 16384
MAX_BATCH = 1 << 16


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no CPU
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "torch kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class TorchEngine:
    """Batched engine on one torch device."""

    # below this many forms a host GMP compose per element is cheaper than
    # one batched compose on the device
    min_batch_encrypt = 64

    def __init__(self, hsm2k: CLHSM2k, device="cuda"):
        self.hsm = hsm2k
        self.device = resolve_device(device)
        disc_bits = (-hsm2k.Delta).bit_length()
        L, _ = CGCtx.widths_for_disc_bits(disc_bits)
        self.L = L
        delta4 = lb.ints_to_limbs([(-hsm2k.Delta) // 4], 2 * L)[0]
        h = bform_from_forms([hsm2k.h, qnudupl(hsm2k.h)], L, "cpu")

        def row(i):
            return tuple(x[i].numpy() for x in h)

        self.cg = CG.from_arrays(disc_bits, delta4, row(0), row(1),
                                 self.device)
        self._identity_form = hsm2k.identity

    def _forms_to_bform(self, forms, batch: int) -> BForm:
        """Forms padded with identities to `batch` rows (as in the JAX
        engine: padded lanes take the identity fast path)."""
        padded = list(forms) + [self._identity_form] * (batch - len(forms))
        return bform_from_forms(padded, self.L, self.device)

    @staticmethod
    def _chunks(n: int, step: int):
        return [(s, min(s + step, n)) for s in range(0, n, step)]

    # ------------------------------------------------------------------- ops
    @torch.inference_mode()
    def compose_forms_batch(self, forms1, forms2):
        """Elementwise class-group composition over raw forms."""
        out = []
        for s, e in self._chunks(len(forms1), MAX_BATCH):
            batch = _bucket(e - s)
            bf = self.cg.compose2(self._forms_to_bform(forms1[s:e], batch),
                                  self._forms_to_bform(forms2[s:e], batch))
            out.extend(bform_to_forms(bf)[:e - s])
        return out

    @torch.inference_mode()
    def part_decrypt_batch(self, share: int, cts):
        """d_i = c1^share for every ct (shared exponent, wNAF ladder)."""
        n = len(cts)
        if share == 0:
            return [self._identity_form] * n
        sched = wnaf_digits(abs(share), WNAF_W)
        out = []
        for s, e in self._chunks(n, MAX_BATCH):
            batch = _bucket(e - s)
            bf = self._forms_to_bform([ct.c1 for ct in cts[s:e]], batch)
            bank = make_wnaf_bank(self.cg, bf, w=WNAF_W)
            r = wnaf_segment(self.cg, bank, identity_bform2(self.cg, batch),
                             sched)
            out.extend(bform_to_forms(r)[:e - s])
        if share < 0:
            out = [reduce_form(qneg(f)) for f in out]
        return out

    @torch.inference_mode()
    def decrypt_batch(self, sk: int, cts):
        """m = dlog(c2 * (c1^sk)^-1): batched shared-exponent power, one
        batched compose, then the O(1) host dlog per element."""
        c1sk = self.part_decrypt_batch(sk, cts)
        inv = [reduce_form(qneg(f)) for f in c1sk]
        fm = self.compose_forms_batch([ct.c2 for ct in cts], inv)
        return [self.hsm.dlog_in_F(f) for f in fm]

    @torch.inference_mode()
    def scal_matmul(self, s_tensor: Tensor, ct_tensor: Tensor,
                    zero_ct: CipherText) -> Tensor:
        """ct (n, m) x s (m, p) -> (n, p): res[i,k] = Enc(0) +
        sum_j s[j,k] * ct[i,j], in row chunks (module docstring)."""
        n, m = ct_tensor.shape
        _, p = s_tensor.shape
        nwind = nwind_for_bits(self.hsm.k, YAO_W)
        recoded = np.zeros((m * p, nwind), dtype=np.int32)
        for idx in range(m * p):
            recoded[idx] = signed_windows(int(s_tensor.data[idx]), YAO_W,
                                          nwind)
        chunk = max(1, MATMUL_LANES // (2 * m * p))
        self.last_matmul_phases = dict.fromkeys(
            ("chain_s", "ladder_s", "finalize_s"), 0.0)
        cts = []
        for start in range(0, n, chunk):
            rows = range(start, min(start + chunk, n))
            cts.extend(self._scal_matmul_rows(rows, recoded, ct_tensor,
                                              zero_ct, m, p, nwind))
        return Tensor(cts, (n, p))

    def _scal_matmul_rows(self, rows, recoded, ct_tensor, zero_ct,
                          m: int, p: int, nwind: int):
        """One chunk of ct rows -> its (n_rows * p) result ciphertexts in
        (row, k) order."""
        nr = len(rows)
        plan = get_plan(2 * nr, m, p, nwind, YAO_W)
        # digit lane r = ((hi*m + j)*p + kk) -> scalar (j*p + kk)
        digits = np.ascontiguousarray(np.tile(recoded.T, (1, 2 * nr)))
        jobs = torch.as_tensor(plan.jobs_b(digits), dtype=torch.long,
                               device=self.device)
        cells = [ct_tensor.at(i, j) for i in rows for j in range(m)]
        bf_cells = bform_from_forms([ct.c1 for ct in cells]
                                    + [ct.c2 for ct in cells], self.L,
                                    self.device)
        phases = self.last_matmul_phases
        t0 = time.perf_counter()
        stack = make_chain_stack(self.cg, nwind, YAO_W)(bf_cells)
        chain = BForm(*(x.reshape((nwind * plan.Bb,) + x.shape[2:])
                        for x in stack))
        del stack
        t1 = self._synced_clock()
        smallbank = make_ladder(self.cg, plan)(chain, jobs)
        del chain
        t2 = self._synced_clock()
        bf_zero = bform_from_forms([zero_ct.c1] * (nr * p)
                                   + [zero_ct.c2] * (nr * p), self.L,
                                   self.device)
        forms = bform_to_forms(make_phase2(self.cg, plan)(smallbank, bf_zero))
        t3 = time.perf_counter()
        phases["chain_s"] += t1 - t0
        phases["ladder_s"] += t2 - t1
        phases["finalize_s"] += t3 - t2
        return [CipherText(forms[i], forms[nr * p + i]) for i in range(nr * p)]

    def _synced_clock(self) -> float:
        """Host clock after the device has finished the queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()
