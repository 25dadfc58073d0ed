"""TorchEngine: the GPU compute path behind the port's CryptoSystem facade
(torch port of cofhe_tpu/ops/engine.py).

Every batched op comes down to `CG.compose2` on int32 limb tensors:

  * compose_forms_batch - one batched composition (the batched encrypt);
  * add_batch           - one composition over the stacked (c1, c2) rows of
                          both operands;
  * scal_batch          - the signed-digit Yao ladder (ops/nupow2.py) over
                          the stacked rows, per-element host-recoded digits;
  * scal_matmul         - ct(n, m) x pt(m, p) through the job stream of
                          ops/matmul2.py, in row chunks of about
                          `MATMUL_LANES` exponent lanes: per chunk the
                          doubling chain, the ladder + contraction, the Yao
                          finalization and the Enc(0) fold;
  * part_decrypt_batch / decrypt_batch - the shared-exponent wNAF ladder
                          (the exponent is the host-known share or secret
                          key), then the host-side closed-form dlog;
  * combine_batch       - the threshold combine: lambda = (1, -1, ..., -1)
                          on the host, the composition tree over parties
                          (parallel/sharded.py), c2 * d^-1, the host dlog.

Tensors live on the engine's device: "cuda" (the default of the facade)
runs the Hopper kernels, compose2 and the wNAF ladder as CUDA graph
replays (ops/graphs.py); "cpu" runs their plain torch versions and the
same ladder steps eagerly. Results are bit-exact with the host oracle
(unique reduced forms). Ciphertext batches stack 2n rows, so they run in
chunks of MAX_BATCH / 2.

One stream an engine. On a card the engine owns a stream (`stream`,
graphs.owned_stream: non-blocking, priority 0, no other live engine's),
made at construction; every op runs on it, from the uploads of forms to
the read-back of the results, which synchronizes that stream alone. The
stream waits once, at construction, for what the constructor queued on
the caller's stream (the CG's constants); the ops take and return forms on
the host, so nothing else of the caller's stream is read. Engines in one
process (the network's nodes) so queue their work apart, and the card runs
one node's part-decryption beside another's, which one shared stream
would run one after the other; ops/graphs.py gives the rules of the CG's
graphs on it. On the CPU `stream` is None and nothing changes.

With a `mesh` (parallel/sharded.py) the engine runs SPMD, as the JAX
engine does under a global mesh: every rank calls the same method with the
same inputs and every rank returns the full result.

  * compose_forms_batch, add_batch, scal_batch and the last compose of
    combine_batch split a bucketed batch into mesh-size row blocks when the
    mesh size divides it; each rank runs its block and the blocks are
    gathered;
  * scal_matmul takes the dp x tp sharded matmul when dp * tp > 1,
    2n % dp == 0 and m % tp == 0 (its seconds in `last_sharded_phases`);
  * combine_batch gathers the parties' rows over tp when tp == t > 1;
  * the wNAF part-decryption stays local to each rank.
Otherwise every rank runs the one-device path on the whole batch.

While tracing is on (utils/trace.py) the engine records the spans
`engine.part_decrypt` (part_decrypt_batch, with the discriminant's bits
`disc_bits` and the ladder's `lanes`), `engine.recode` (the matmul's
signed-window recoding of the plaintext) and, per matmul chunk,
`engine.matmul.chain`, `.ladder` and `.finalize`. The chain and ladder
spans then end after a synchronize, so each holds its device work, and
their seconds, summed over chunks, are `last_matmul_phases` (`chain_s`,
`ladder_s`, `finalize_s`). Untraced, a chunk does not synchronize and
`last_matmul_phases` is absent.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.cl_hsm2k import CipherText, CLHSM2k
from ..core.qfi import neg as qneg, nudupl as qnudupl, reduce_form
from ..parallel.sharded import (_scan_tree_compose, gather_bform,
                                sharded_matmul, sharded_threshold_combine)
from ..tensor import Tensor
from ..utils import trace
from . import limb as lb
from .forms import BForm, bform_from_forms, bform_neg, bform_to_forms
from .forms2 import CG, CGCtx
from .graphs import owned_stream
from .matmul2 import get_plan, make_chain, make_ladder, make_phase2
from .nupow2 import (identity_bform2, make_wnaf_bank, nupow_yao2,
                     nwind_for_bits, signed_windows, wnaf_digits,
                     wnaf_segment)

YAO_W = 4   # signed-digit window of the matmul's per-element exponents
WNAF_W = 5  # wNAF window of the shared decrypt exponent
# exponent lanes (2 * rows * m * p) per matmul chunk, and forms per batched
# compose or decrypt call: both bound the device memory of one call
MATMUL_LANES = 16384
MAX_BATCH = 1 << 16


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _on_stream(op):
    """An engine op run on the engine's stream (in place on the CPU)."""
    @functools.wraps(op)
    def call(self, *args, **kwargs):
        if self.stream is None:
            return op(self, *args, **kwargs)
        with torch.cuda.stream(self.stream):
            return op(self, *args, **kwargs)
    return call


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
    """Batched engine on one torch device, optionally one rank of a mesh."""

    # below this many forms a host GMP compose per element is cheaper than
    # one batched compose on the device
    min_batch_encrypt = 64

    def __init__(self, hsm2k: CLHSM2k, device="cuda", mesh=None):
        self.hsm = hsm2k
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            self._coord = mesh.coordinate()
            if self._coord is None:
                raise ValueError("this rank lies outside the mesh")
        disc_bits = (-hsm2k.Delta).bit_length()
        L, _ = CGCtx.widths_for_disc_bits(disc_bits)
        self.L = L
        delta4 = lb.ints_to_limbs([(-hsm2k.Delta) // 4], 2 * L)[0]
        h = bform_from_forms([hsm2k.h, qnudupl(hsm2k.h)], L, "cpu")

        def row(i):
            return tuple(x[i].numpy() for x in h)

        self.cg = CG.from_arrays(disc_bits, delta4, row(0), row(1), self.device)
        self._identity_form = hsm2k.identity
        self.stream = None
        if self.device.type == "cuda":
            dev = self.cg.device
            self.stream = self.cg.compose_graphs.stream = owned_stream(self.cg, dev)
            self.stream.wait_stream(torch.cuda.current_stream(dev))

    def _forms_to_bform(self, forms, batch: int, rows=None) -> BForm:
        """Forms padded with identities to `batch` rows (as in the JAX
        engine: padded lanes take the identity fast path); only the slice
        `rows` of them when given."""
        padded = list(forms) + [self._identity_form] * (batch - len(forms))
        return bform_from_forms(padded[rows or slice(None)], self.L,
                                self.device)

    def _cts_to_bform(self, cts, rows=None) -> BForm:
        """Stack [c1s..., c2s...] into one identity-padded batch of
        _bucket(2n) rows (the slice `rows` of it when given)."""
        forms = [ct.c1 for ct in cts] + [ct.c2 for ct in cts]
        return self._forms_to_bform(forms, _bucket(2 * len(cts)), rows)

    # ------------------------------------------------------------------ mesh
    def _mesh_dims(self) -> tuple[int, int]:
        return (1, 1) if self.mesh is None else (self.mesh.dp, self.mesh.tp)

    def _row_block(self, batch: int) -> slice:
        """This rank's rows of a batch: block d * tp + t of mesh-size
        blocks when the mesh divides the batch (the JAX engine's
        _rows_divisible), else all of it."""
        if self.mesh is None or self.mesh.size == 1 or batch % self.mesh.size:
            return slice(0, batch)
        d, t = self._coord
        blk = batch // self.mesh.size
        r = d * self.mesh.tp + t
        return slice(r * blk, (r + 1) * blk)

    def _gather_rows(self, bf: BForm, batch: int) -> BForm:
        """The whole batch from every rank's row block (a no-op when this
        rank ran all of it): gathered over tp, then over dp."""
        if bf.a.shape[0] == batch:
            return bf
        for axis in ("tp", "dp"):
            if self.mesh.shape[axis] > 1:
                bf = BForm(*(x.reshape((-1,) + x.shape[2:]) for x in
                             gather_bform(bf, self.mesh.group(axis))))
        return bf

    @staticmethod
    def _bform_to_cts(bf: BForm, n: int):
        out = bform_to_forms(bf)
        return [CipherText(out[i], out[n + i]) for i in range(n)]

    @staticmethod
    def _digits_for(scalars, rows: int, nwind: int, row_map) -> np.ndarray:
        """(nwind, rows) signed digits; row_map[r] indexes scalars, or is -1
        for an identity-pad row (digit 0)."""
        recoded = np.zeros((len(scalars), nwind), dtype=np.int32)
        for i, s in enumerate(scalars):
            recoded[i] = signed_windows(int(s), YAO_W, nwind)
        out = np.zeros((rows, nwind), dtype=np.int32)
        live = row_map >= 0
        out[live] = recoded[row_map[live]]
        return np.ascontiguousarray(out.T)

    @staticmethod
    def _chunks(n: int, step: int):
        return [(s, min(s + step, n)) for s in range(0, n, step)]

    # ------------------------------------------------------------------- ops
    @_on_stream
    @torch.inference_mode()
    def compose_forms_batch(self, forms1, forms2):
        """Elementwise class-group composition over raw forms."""
        out = []
        for s, e in self._chunks(len(forms1), MAX_BATCH):
            batch = _bucket(e - s)
            rows = self._row_block(batch)
            bf = self.cg.compose2(
                self._forms_to_bform(forms1[s:e], batch, rows),
                self._forms_to_bform(forms2[s:e], batch, rows))
            out.extend(bform_to_forms(self._gather_rows(bf, batch))[:e - s])
        return out

    @_on_stream
    @torch.inference_mode()
    def add_batch(self, cts1, cts2):
        """Elementwise ciphertext addition: (c1 * c1', c2 * c2')."""
        out = []
        for s, e in self._chunks(len(cts1), MAX_BATCH // 2):
            batch = _bucket(2 * (e - s))
            rows = self._row_block(batch)
            bf = self.cg.compose2(self._cts_to_bform(cts1[s:e], rows),
                                  self._cts_to_bform(cts2[s:e], rows))
            out.extend(self._bform_to_cts(self._gather_rows(bf, batch), e - s))
        return out

    @_on_stream
    @torch.inference_mode()
    def scal_batch(self, scalars, cts):
        """Elementwise ct^s for non-negative scalars below 2^k. Layout of a
        chunk: [c1 x n, c2 x n, identity pad]; pad rows take digit 0."""
        nwind = nwind_for_bits(self.hsm.k, YAO_W)
        out = []
        for s, e in self._chunks(len(cts), MAX_BATCH // 2):
            n = e - s
            batch = _bucket(2 * n)
            rows = self._row_block(batch)
            row_map = np.full(batch, -1, dtype=np.int64)
            row_map[:n] = np.arange(n)
            row_map[n:2 * n] = np.arange(n)
            digits = self._digits_for(list(scalars[s:e]), batch, nwind, row_map)
            bf = nupow_yao2(self.cg, self._cts_to_bform(cts[s:e], rows),
                            np.ascontiguousarray(digits[:, rows]), w=YAO_W)
            out.extend(self._bform_to_cts(self._gather_rows(bf, batch), n))
        return out

    @_on_stream
    @torch.inference_mode()
    def combine_batch(self, cts, pdrs_per_party):
        """final_decrypt over a batch: d = d_0 * (d_1 * ... * d_{t-1})^-1
        (lambda = (1, -1, ..., -1), applied on the host), then
        m = dlog(c2 * d^-1) on the host. With a mesh whose tp == t > 1 the
        rank at tp coordinate i signs and uploads party i's rows only, and
        the parties meet in an all_gather over tp."""
        t = len(pdrs_per_party)
        sharded = self._mesh_dims()[1] == t > 1

        def signed(i, s, e):
            p = pdrs_per_party[i][s:e]
            return list(p) if i == 0 else [reduce_form(qneg(f)) for f in p]

        out = []
        for s, e in self._chunks(len(cts), MAX_BATCH):
            batch = _bucket(e - s)
            if sharded:
                d = sharded_threshold_combine(self.cg, self.mesh, self._forms_to_bform(
                    signed(self._coord[1], s, e), batch))
            else:
                stacks = [self._forms_to_bform(signed(i, s, e), batch)
                          for i in range(t)]
                d = _scan_tree_compose(
                    self.cg, BForm(*(torch.stack(xs) for xs in zip(*stacks))), t)
            rows = self._row_block(batch)
            c2 = self._forms_to_bform([ct.c2 for ct in cts[s:e]], batch, rows)
            fm = self.cg.compose2(c2, bform_neg(BForm(*(x[rows] for x in d))))
            out.extend(self.hsm.dlog_in_F(f) for f in
                       bform_to_forms(self._gather_rows(fm, batch))[:e - s])
        return out

    def _part_decrypt_attrs(self, share: int, cts) -> dict:
        """The `engine.part_decrypt` span's attributes: the discriminant's
        bits and the ladder's lanes (its first chunk's bucket; 0 where no
        ladder runs)."""
        n = len(cts) if share else 0
        return {"disc_bits": self.cg.disc_bits,
                "lanes": _bucket(min(n, MAX_BATCH)) if n else 0}

    @trace.traced("engine.part_decrypt", _part_decrypt_attrs)
    @_on_stream
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

    @_on_stream
    @torch.inference_mode()
    def decrypt_batch(self, sk: int, cts):
        """m = dlog(c2 * (c1^sk)^-1): batched shared-exponent power, one
        batched compose, then the O(1) host dlog per element."""
        c1sk = self.part_decrypt_batch(sk, cts)
        inv = [reduce_form(qneg(f)) for f in c1sk]
        fm = self.compose_forms_batch([ct.c2 for ct in cts], inv)
        return [self.hsm.dlog_in_F(f) for f in fm]

    @_on_stream
    @torch.inference_mode()
    def scal_matmul(self, s_tensor: Tensor, ct_tensor: Tensor,
                    zero_ct: CipherText) -> Tensor:
        """ct (n, m) x s (m, p) -> (n, p): res[i,k] = Enc(0) +
        sum_j s[j,k] * ct[i,j], in row chunks, or sharded over the mesh
        (module docstring)."""
        n, m = ct_tensor.shape
        _, p = s_tensor.shape
        nwind = nwind_for_bits(self.hsm.k, YAO_W)
        with trace.span("engine.recode"):
            recoded = np.zeros((m * p, nwind), dtype=np.int32)
            for idx in range(m * p):
                recoded[idx] = signed_windows(int(s_tensor.data[idx]), YAO_W,
                                              nwind)
        dp, tp = self._mesh_dims()
        if dp * tp > 1 and (2 * n) % dp == 0 and m % tp == 0:
            return self._scal_matmul_sharded(recoded, ct_tensor, zero_ct,
                                             n, m, p, nwind)
        chunk = max(1, MATMUL_LANES // (2 * m * p))
        phases = None
        if trace.on():
            phases = self.last_matmul_phases = dict.fromkeys(
                ("chain_s", "ladder_s", "finalize_s"), 0.0)
        else:
            self.__dict__.pop("last_matmul_phases", None)
        cts = []
        for start in range(0, n, chunk):
            rows = range(start, min(start + chunk, n))
            cts.extend(self._scal_matmul_rows(rows, recoded, ct_tensor,
                                              zero_ct, m, p, nwind, phases))
        return Tensor(cts, (n, p))

    def _scal_matmul_rows(self, rows, recoded, ct_tensor, zero_ct,
                          m: int, p: int, nwind: int, phases=None):
        """One chunk of ct rows -> its (n_rows * p) result ciphertexts in
        (row, k) order; the phases' seconds added to `phases` when given."""
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
        with trace.span("engine.matmul.chain") as chain_span:
            chain = make_chain(self.cg, plan)(bf_cells)
            if chain_span:
                self._synchronize()
        with trace.span("engine.matmul.ladder") as ladder_span:
            smallbank = make_ladder(self.cg, plan)(chain, jobs)
            del chain
            if ladder_span:
                self._synchronize()
        # ends in a host read of the results
        with trace.span("engine.matmul.finalize") as finalize_span:
            bf_zero = bform_from_forms([zero_ct.c1] * (nr * p)
                                       + [zero_ct.c2] * (nr * p), self.L,
                                       self.device)
            forms = bform_to_forms(make_phase2(self.cg, plan)(smallbank, bf_zero))
        if phases is not None and chain_span and ladder_span and finalize_span:
            phases["chain_s"] += chain_span.seconds
            phases["ladder_s"] += ladder_span.seconds
            phases["finalize_s"] += finalize_span.seconds
        return [CipherText(forms[i], forms[nr * p + i]) for i in range(nr * p)]

    def _scal_matmul_sharded(self, recoded, ct_tensor, zero_ct, n: int,
                             m: int, p: int, nwind: int) -> Tensor:
        """The whole matmul over the mesh (parallel/sharded.py): rank (d, t)
        takes stacked rows hi of dp block d (rows2_loc = 2n/dp of them) and
        contraction columns j of tp block t (m_loc = m/tp), the JAX engine's
        layout. Host packing, the device run with its gathers, and the
        rebuild of the ciphertexts are timed in `last_sharded_phases`."""
        t_start = time.perf_counter()
        d, t = self._coord
        rows2_loc, m_loc = 2 * n // self.mesh.dp, m // self.mesh.tp
        plan = get_plan(rows2_loc, m_loc, p, nwind, YAO_W)

        def stacked(hi, j):  # stacked row hi: c1 of ct row hi, then c2 rows
            ct = ct_tensor.at(hi % n, j)
            return ct.c1 if hi < n else ct.c2

        his = range(d * rows2_loc, (d + 1) * rows2_loc)
        js = range(t * m_loc, (t + 1) * m_loc)
        cells = bform_from_forms([stacked(hi, j) for hi in his for j in js],
                                 self.L, self.device)
        # Enc(0) rows [c1 x n*p, c2 x n*p], block d of rows2_loc * p
        zrows = range(d * rows2_loc * p, (d + 1) * rows2_loc * p)
        zero = bform_from_forms([zero_ct.c1 if i < n * p else zero_ct.c2
                                 for i in zrows], self.L, self.device)
        # the digits depend only on (j, kk): tp block t's, tiled over rows
        digits = np.ascontiguousarray(np.tile(
            recoded.reshape(m, p, nwind)[js.start:js.stop]
            .reshape(m_loc * p, nwind).T, (1, rows2_loc)))
        jobs = torch.as_tensor(plan.jobs_b(digits), dtype=torch.long,
                               device=self.device)
        t_packed = time.perf_counter()
        out = sharded_matmul(self.cg, plan, self.mesh, cells, zero, jobs)
        out = BForm(*(x.cpu() for x in out))
        t_device = time.perf_counter()
        forms = bform_to_forms(out)
        cts = [CipherText(forms[i], forms[n * p + i]) for i in range(n * p)]
        self.last_sharded_phases = {"pack_s": t_packed - t_start,
                                    "device_s": t_device - t_packed,
                                    "rebuild_s": time.perf_counter() - t_device}
        return Tensor(cts, (n, p))

    def _synchronize(self) -> None:
        """Wait for the engine's queued work (traced matmul phases only)."""
        if self.stream is not None:
            self.stream.synchronize()
