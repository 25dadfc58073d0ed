"""The kernels of this checkout against those built from an earlier csrc/
directory, on the operands the main path (and the NUCOMP tail) really
passes, on one CUDA card.

    python3 -m cofhe_tpu_torch.tools.kernel_compare --baseline-csrc DIR

DIR holds the earlier sources of the kernels (and warp_limbs.cuh) with
this checkout's C entry points (cuda_group._ARGTYPES); for example an
unpacked `git archive <commit> cofhe_tpu_torch/csrc`. A kernel whose
source DIR lacks (KT, K5m, K5d or K4 before they existed) is compared
with nothing; K7, the NUCOMP tail's Lehmer walk, is then held to its plain
version and timed beside it. The earlier K1 is
the 13-divstep kernel: it gets its loop cap in 13-step groups (a cap that
also covers any kernel of longer groups, whose loop ends once g is zero),
and its trips count 13 divsteps a group. Where an earlier kernel is the
same source as this checkout's, its pair of times shows the spread of the
measurement. From the root of a checkout, the script:

1. builds this checkout's kernels and the earlier ones side by side, and
   counts the tensor-core products (IMMA), warp collectives (SHFL, VOTE,
   REDUX), shared atomics and barriers in the SASS of each K5m and KT
   instance of both (cuobjdump -sass);
2. drives chip_smoke's main path once (its checks included) and its graph
   against eager decrypt, recording the operands of one decrypt, chain
   and ladder compose2, and of one eager NUCOMP compose2 on 128 of the
   main path's ciphertexts (K7's);
3. runs the main path's matmul twice more in the same process on the same
   inputs and Enc(0), eagerly (a captured graph would keep this
   checkout's kernels), with this checkout's kernels and with the earlier
   ones: seconds, and whether the outputs equal the main run's;
4. on each recorded operand, checks that both kernels agree (K1, K2, KT,
   K5m, K5d and K4 bit for bit, K3 after the exact tail) and times them in
   turns (earlier, this, this, earlier), with each one's trips and bound
   (the earlier K1's at its 13-divstep per-limb count, the others at this
   checkout's counts; K5m's, K5d's and K4's bound is the function's own,
   the same for both);
5. times K5m and KT against the baseline's on chip_smoke's synthetic
   operands at 128, 1001 and 16384 lanes (K5m at compose2's product
   shapes; KT with and without deep-tail lanes, and on reduced forms), and
   K7 on chip_smoke's compose2 walk operands at the same batches;
6. profiles one eager compose2 at 128 lanes with each set of kernels.

With --baseline-tree DIR it compares whole compose2s instead: DIR is
another checkout (an unpacked `git archive <commit>`), and this
checkout's package and DIR's run in turns (DIR, this, this, DIR), each
turn a process of its own that imports only its tree's package (and this
checkout's chip_smoke.py for its profiles) and builds that tree's
kernels. A turn profiles one compose2 at 128 lanes by graph replay and
one eagerly with "other" split by section (chip_smoke.profile_compose:
device ms and device kernels), times compose2 by replay at 128, 256 and
16384 lanes on the card's clock, and runs 1285 replays at 128 lanes (the
compose2 steps of the main path's decrypt) on the host's clock.

With --k7-phases it runs K7 alone: the SASS of both trees' K7 instances
at NPT = 5 (instructions by kind; in a build with -DK7_PHASES also those
between consecutive clock reads), K7 against the baseline's in turns on
the walk operands at 128, 1001 and 16384 lanes, and each tree's split of
a group's clock64() cycles by phase, where its source has the K7_PHASES
hooks (PhaseLib).

Any disagreement raises. chip_smoke.py stays the check the port must pass;
this script only measures.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import json
import os
import random
import re
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE_K1_STEPS = 13  # divsteps a group of the earlier K1
# calls a timed turn at most: timed() holds the card with a spin kernel
# while the host queues the calls, but with thousands of them a ~0.01 ms
# kernel (K5d, K4 at 128 lanes) was timed at the host's launch rate
MAX_TURN_CALLS = 200


class Baseline:
    """The kernels of another csrc/ directory, built with the package's
    nvcc flags and called on the same tensors through this checkout's C
    entry points."""

    def __init__(self, csrc: str, cgp, fail):
        self.csrc, self.cgp, self.fail, self.fns, self.procs = csrc, cgp, fail, {}, {}
        self.out_dir = os.path.join(cgp.BUILD_DIR, "baseline")
        self.kernels = [n for n in cgp.KERNELS if hasattr(self, n)
                        and os.path.exists(os.path.join(csrc, f"{n}.cu"))]

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        for name in self.kernels:
            out = os.path.join(self.out_dir, f"lib{name}.so")
            cmd = [self.cgp._nvcc(), *self.cgp.NVCC_FLAGS, "-o", out,
                   os.path.join(self.csrc, f"{name}.cu")]
            self.procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)

    def finish(self) -> None:
        for name, (p, out) in self.procs.items():
            text, _ = p.communicate()
            if p.returncode:
                self.fail(f"baseline {name} did not build:\n{text}")
            fn = getattr(ctypes.CDLL(out), f"{name}_launch")
            fn.restype, fn.argtypes = ctypes.c_int, self.cgp._ARGTYPES[name]
            self.fns[name] = fn

    def _call(self, torch, name, *args):
        rc = self.fns[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            self.fail(f"baseline {name} launch failed: cudaError {rc}")

    @staticmethod
    def _ptr(t):
        return None if t is None else t.data_ptr()

    def xgcd_coeff_g(self, torch, f, g, m, nbits, need_u=False, iters=None):
        d, cg = torch.empty_like(f), torch.empty_like(f)
        cu = torch.empty_like(f) if need_u else None
        self._call(torch, "xgcd_coeff_g", f.data_ptr(), g.data_ptr(), m.data_ptr(),
                   d.data_ptr(), cg.data_ptr(), self._ptr(cu), self._ptr(iters),
                   f.shape[0], f.shape[1],
                   self.cgp.xgcd2.groups_for_bits(nbits, BASELINE_K1_STEPS), int(need_u))
        return (d, cg, cu) if need_u else (d, cg)

    def mod_topdown(self, torch, x, m, max_iters, iters=None):
        out = torch.empty_like(x)
        self._call(torch, "mod_topdown", x.data_ptr(), m.data_ptr(),
                   out.data_ptr(), self._ptr(iters), x.shape[0], x.shape[1],
                   m.shape[1], int(max_iters))
        return out

    def reduce2_grouped(self, torch, a, b, c, dD_mant, dD_top, red_iters, iters=None):
        ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
        self._call(torch, "reduce2_grouped", a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), ao.data_ptr(), bo.data_ptr(), co.data_ptr(),
                   self._ptr(iters), a.shape[0], a.shape[1], int(dD_top),
                   int(red_iters), float(dD_mant))
        return ao, bo, co

    def reduce_exact(self, torch, a, b, c, max_iters, iters=None):
        ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
        bs = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
        self._call(torch, "reduce_exact", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   ao.data_ptr(), bs.data_ptr(), bo.data_ptr(), co.data_ptr(),
                   self._ptr(iters), a.shape[0], a.shape[1], int(max_iters))
        return self.cgp.BForm(ao, bs, bo, co)

    def mag_mul(self, torch, ma, mb, L_out=None):
        La, Lb = ma.shape[-1], mb.shape[-1]
        L_out = La + Lb if L_out is None else L_out
        ma, mb, lead = self.cgp._broadcast("mag_mul", ma, mb)
        a, sa = self.cgp._rows("mag_mul", ma)
        b, sb = self.cgp._rows("mag_mul", mb, a)
        out = torch.empty((a.shape[0], L_out), dtype=torch.int32, device=a.device)
        self._call(torch, "mag_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   a.shape[0], La, Lb, sa, sb, L_out)
        return out.reshape(*lead, L_out)

    def divexact_odd(self, torch, x, y, L_out, inv=None):
        Lx, Ly = x.shape[-1], y.shape[-1]
        x, y, lead = self.cgp._broadcast("mag_divexact_odd", x, y)
        xr, sx = self.cgp._rows("mag_divexact_odd", x)
        yr, sy = self.cgp._rows("mag_divexact_odd", y, xr)
        q = torch.empty((xr.shape[0], L_out), dtype=torch.int32, device=xr.device)
        self._call(torch, "divexact_odd", xr.data_ptr(), yr.data_ptr(), q.data_ptr(),
                   xr.shape[0], Lx, Ly, sx, sy, L_out)
        return q.reshape(*lead, L_out)

    def redc_mod(self, torch, x, d, steps, active=None, inv=None):
        xr, sx = self.cgp._rows("redc_mod", x)
        dr, sd = self.cgp._rows("redc_mod", d, xr)
        out = torch.empty(xr.shape, dtype=torch.int32, device=xr.device)
        act = None if active is None else active.contiguous()
        self._call(torch, "redc_mod", xr.data_ptr(), dr.data_ptr(), self._ptr(act),
                   out.data_ptr(), xr.shape[0], xr.shape[1], dr.shape[1], sx, sd, int(steps))
        return out

    def lehmer_euclid(self, torch, r0, r1, stop, max_groups, sim_steps=8,
                      active=None, iters=None):
        B, L = r0.shape
        rows = [torch.empty_like(r0) for _ in range(6)]
        par = torch.empty(B, dtype=torch.int32, device=r0.device)
        work = torch.empty(B + 2, dtype=torch.int32, device=r0.device)
        self._call(torch, "lehmer_euclid", r0.data_ptr(), r1.data_ptr(), stop.data_ptr(),
                   self._ptr(active), *(r.data_ptr() for r in rows), par.data_ptr(),
                   self._ptr(iters), work.data_ptr(), B, L, int(max_groups),
                   int(sim_steps))
        return (*rows, par)


@contextlib.contextmanager
def baseline_in_place(torch, cgp, base):
    """cuda_group's kernel wrappers replaced by the baseline's (those it
    has)."""
    wrapper = {n: cgp.DISPATCH[n].name + "_cuda" for n in base.kernels}
    saved = {n: getattr(cgp, w) for n, w in wrapper.items()}
    for n, w in wrapper.items():
        setattr(cgp, w, lambda *a, _n=n, **k: getattr(base, _n)(torch, *a, **k))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cgp, wrapper[n], fn)


def matmul_again(torch, smoke, cgp, base, main) -> None:
    """The main path's matmul once more with this checkout's kernels and
    once with the baseline's, on the same inputs and Enc(0)."""
    from cofhe_tpu_torch.core.qfi import is_reduced, reduce_form
    from cofhe_tpu_torch.utils import trace

    cs, pk, pt, ct, res = (main[k] for k in ("cs", "pk", "pt", "ct", "res"))
    cg = cs._engine.cg
    cg.compose2 = cg.compose2_eager  # the reruns are eager (the baseline has no graphs)
    try:
        for label in ("this checkout's kernels", "the baseline kernels"):
            cs.rand_gen = copy.deepcopy(main["rand_at_matmul"])  # the same Enc(0)
            swap = baseline_in_place(torch, cgp, base) if label.startswith("the baseline") \
                else contextlib.nullcontext()
            # traced: the matmul then fills last_matmul_phases
            with swap, trace.enabled():
                t = time.perf_counter()
                again = cs.scal_ciphertext_tensors(pk, pt, ct)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
            differ, unreduced, other_class = [], 0, 0
            for i, (x, y) in enumerate(zip(again.data, res.data)):
                for fx, fy in zip(x, y):
                    if fx != fy:
                        differ.append(i)
                        unreduced += not is_reduced(fx)
                        other_class += reduce_form(fx) != fy
            smoke.log(f"matmul again (eager) with {label}: {secs:.3f} s, phases " + json.dumps(
                          {k: round(v, 3) for k, v in cs._engine.last_matmul_phases.items()})
                      + f"; {len(differ)} of {2 * len(res.data)} output forms differ from "
                      f"the main run's, {unreduced} of them not reduced, {other_class} "
                      f"of another class")
            if differ:
                smoke.fail(f"the matmul again with {label} gave other ciphertexts")
    finally:
        del cg.compose2  # the class's compose2, by replays, again


def in_turns(torch, smoke, new_fn, old_fn):
    """Times the two kernels in turns, earlier, this, this, earlier: (this
    ms, earlier ms, {"new": [ms, ms], "old": [ms, ms]}, calls a turn). A
    first timing warms the card and sizes each turn to >= 20 ms of calls,
    at most MAX_TURN_CALLS of them."""
    reps = min(MAX_TURN_CALLS,
               max(smoke.TIMING_REPS, int(20.0 / smoke.timed(torch, new_fn, 3))))
    t = {"new": [], "old": []}
    for turn, fn in (("old", old_fn), ("new", new_fn), ("new", new_fn), ("old", old_fn)):
        t[turn].append(smoke.timed(torch, fn, reps))
    return sum(t["new"]) / 2, sum(t["old"]) / 2, t, reps


def compare_synthetic(torch, smoke, cgp, port, base, cg, gmp, hsm, rng) -> None:
    """K5m at compose2's product shapes and KT on chip_smoke's synthetic
    operands at 128, 1001 and 16384 lanes, this checkout's kernel against
    the baseline's, bit for bit and in turns: K5m on random operands
    (chip_smoke.k5m_operands); KT on K3's outputs of compose2 operand
    pairs with deep-tail lanes (self-composes, inverse pairs, powers of f;
    chip_smoke.kt_operands), without them, and on forms that are reduced
    already (no step: load, canonicalize, compare, store)."""
    def line(label, ms, old_ms, t, reps, extra=""):
        smoke.log(f"synthetic {label}: this kernel {ms:.4f} ms, baseline {old_ms:.4f} ms, "
                  f"{old_ms / ms:.2f}x; turns {t['old'][0]:.4f} {t['new'][0]:.4f} "
                  f"{t['new'][1]:.4f} {t['old'][1]:.4f} ms, {reps} calls each{extra}")

    forms = gmp.nupow_batch([hsm.h] * 64, [rng.getrandbits(1100) for _ in range(64)])
    for B in (smoke.SMALL_B, smoke.RAGGED_B, smoke.KERNEL_B):
        for La, Lb, Lo in (smoke.K5M_SHAPES if "mag_mul" in base.kernels else ()):
            av, bv = smoke.k5m_operands(rng, B, La, Lb, False)
            a, b = smoke._limbs(torch, port.lb, av, La), smoke._limbs(torch, port.lb, bv, Lb)
            if smoke.max_abs_diff(torch, [base.mag_mul(torch, a, b, Lo)],
                                  [cgp.mag_mul_cuda(a, b, Lo)]):
                smoke.fail(f"synthetic K5m {La}x{Lb}->{Lo} B={B}: the baseline disagrees")
            bnd = smoke.k5m_bound(B, La, Lb, Lo)[0]
            ms, old_ms, t, reps = in_turns(torch, smoke, lambda: cgp.mag_mul_cuda(a, b, Lo),
                                           lambda: base.mag_mul(torch, a, b, Lo))
            line(f"mag_mul[La={La},Lb={Lb},L_out={Lo}]@B={B}", ms, old_ms, t, reps,
                 f"; bound {bnd:.5f} ms, {bnd / ms:.1%} / {bnd / old_ms:.1%} of it")
        if "reduce_exact" not in base.kernels:
            continue
        cap = cg.tail_iters
        for label in ("deep-tail", "compose", "reduced"):
            if label == "reduced":
                e = port.bform_from_forms([forms[rng.randrange(64)] for _ in range(B)],
                                          cg.L, "cuda")
                raw = (e.a, e.b_sign[:, None] * e.b, e.c)
            else:
                _, _, raw = smoke.kt_operands(cgp, cg, hsm, port, rng, forms, B,
                                              deep=label == "deep-tail")
            it_new = torch.zeros(B, dtype=torch.int32, device="cuda")
            it_old = torch.zeros_like(it_new)
            got = cgp.reduce_exact_cuda(*raw, cap, iters=it_new)
            old = base.reduce_exact(torch, *raw, cap, iters=it_old)
            if smoke.max_abs_diff(torch, got, old) or not torch.equal(it_new, it_old):
                smoke.fail(f"synthetic KT {label} B={B}: the baseline disagrees")
            ops = float(it_new.long().sum()) * cg.L * smoke.OPS_KT
            bnd = smoke.bound(ops, 4.0 * B * (6 * cg.L + 2))[0]
            ms, old_ms, t, reps = in_turns(torch, smoke, lambda: cgp.reduce_exact_cuda(*raw, cap),
                                           lambda: base.reduce_exact(torch, *raw, cap))
            line(f"reduce_exact[W={cg.L},{label}]@B={B}", ms, old_ms, t, reps,
                 f"; steps {smoke._stats(it_new)} (both), sum {int(it_new.long().sum())}; "
                 f"bound {bnd:.5f} ms, {bnd / ms:.1%} / {bnd / old_ms:.1%} of it")


def nucomp_operands(torch, smoke, cgp, port, main) -> dict:
    """K7's operands of one eager NUCOMP compose2 on the c1 and c2 forms of
    128 of the main path's ciphertexts (chip_smoke's legacy path)."""
    cg = main["cs"]._engine.cg
    ncg = port.f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    cts = main["ct"].data[:smoke.LEGACY_B]
    b1 = port.bform_from_forms([c.c1 for c in cts], cg.L, "cuda")
    b2 = port.bform_from_forms([c.c2 for c in cts], cg.L, "cuda")
    rec = smoke.Recorder(torch, cgp, want={("nucomp", smoke.LEGACY_B)},
                         wrappers=("lehmer_euclid_cuda",))
    rec.phase = "nucomp"
    with rec, torch.inference_mode():
        ncg.compose2_eager(b1, b2)
    return rec.ops


def compare_k7(torch, smoke, cgp, base, label, B, W, r0, r1, stop, mg, active=None):
    """K7 on one set of operands: against its plain version, and against
    the baseline's K7 in turns where the baseline has one, else timed
    beside the plain version."""
    it_new = smoke.k7_compare(torch, cgp, label, r0, r1, stop, mg, active)
    bms = smoke.k7_bound(it_new, B, W)[0]
    new_fn = lambda: cgp.lehmer_euclid_cuda(r0, r1, stop, mg, active=active)  # noqa: E731
    if "lehmer_euclid" not in base.kernels:
        ms = smoke.timed(torch, new_fn, smoke.TIMING_REPS)
        plain_ms = smoke.timed(torch, lambda: cgp.lehmer_euclid_plain(
            r0, r1, stop, mg, active=active), 1, warm=False)
        smoke.log(f"compare {label}: the baseline has no K7; bit-exact vs "
                  f"the plain version, groups {smoke._stats(it_new)}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.1f} ms, bound {bms:.5f} ms ({bms / ms:.1%} of it)")
        return
    it_old = torch.zeros_like(it_new)
    old = base.lehmer_euclid(torch, r0, r1, stop, mg, active=active, iters=it_old)
    if smoke.max_abs_diff(torch, old, cgp.lehmer_euclid_cuda(r0, r1, stop, mg,
                                                             active=active)) \
            or not torch.equal(it_new, it_old):
        smoke.fail(f"{label}: the baseline kernel disagrees")
    ms, old_ms, t, reps = in_turns(torch, smoke, new_fn, lambda: base.lehmer_euclid(
        torch, r0, r1, stop, mg, active=active))
    smoke.log(f"compare {label}: this kernel {ms:.4f} ms ({bms / ms:.1%} of its bound), "
              f"baseline {old_ms:.4f} ms ({bms / old_ms:.1%}), {old_ms / ms:.2f}x (groups "
              f"{smoke._stats(it_new)}, bound {bms:.5f} ms); turns {t['old'][0]:.4f} "
              f"{t['new'][0]:.4f} {t['new'][1]:.4f} {t['old'][1]:.4f} ms, {reps} calls each")


def k7_walk(torch, smoke, cgp, port, base, hsm, cg, gmp, rng, phases=None) -> None:
    """K7 on chip_smoke's compose2 walk operands at 128, 1001 and 16384
    lanes: against its plain version and the baseline's K7 in turns, and,
    with `phases` ({label: PhaseLib}), each instrumented build's split of
    a group's cycles."""
    ncg = port.f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    for B in (smoke.SMALL_B, smoke.RAGGED_B, smoke.KERNEL_B):
        r0, r1, stop = smoke.k7_walk_operands(torch, ncg, gmp, hsm, port.bform_from_forms,
                                              rng, B)
        label = f"lehmer_euclid[W={ncg.L},compose2 walk]@B={B}"
        with torch.inference_mode():
            compare_k7(torch, smoke, cgp, base, label, B, ncg.L, r0, r1, stop, ncg.eu_groups)
            for who, lib in (phases or {}).items():
                lib.split(torch, smoke, f"{label} {who}", r0, r1, stop, ncg.eu_groups)


# phase clock slots of csrc/lehmer_euclid.cu built with -DK7_PHASES
K7_PHASES = ("est", "sim", "digit", "apply", "idle", "other")
K7_KINDS = ("sim", "digit", "idle")


class PhaseLib:
    """A K7 source built with -DK7_PHASES: each lane's clock64() cycles in
    each phase of its groups (three ordered estimates; the Lehmer
    simulation; the big-lane digit step; the matrix apply with its carry
    passes; an idle group's carry passes; the rest: loads, stores, row
    hand-out, loop) and its groups of each kind."""

    def __init__(self, cgp, csrc: str, out: str):
        self.cgp, self.out = cgp, out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        self.proc = subprocess.Popen(
            [cgp._nvcc(), *cgp.NVCC_FLAGS, "-DK7_PHASES", "-o", out,
             os.path.join(csrc, "lehmer_euclid.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    @staticmethod
    def has_hooks(csrc: str) -> bool:
        with open(os.path.join(csrc, "lehmer_euclid.cu")) as f:
            return "K7_PHASES" in f.read()

    def finish(self, fail) -> None:
        text, _ = self.proc.communicate()
        if self.proc.returncode:
            fail(f"K7 with -DK7_PHASES did not build:\n{text}")
        self.fn = ctypes.CDLL(self.out).lehmer_euclid_phases_launch
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = self.cgp._ARGTYPES["lehmer_euclid"][:-1] + [ctypes.c_void_p] * 2

    def split(self, torch, smoke, label, r0, r1, stop, mg) -> None:
        B, L = r0.shape
        rows = [torch.empty_like(r0) for _ in range(6)]
        par = torch.empty(B, dtype=torch.int32, device=r0.device)
        work = torch.empty(B + 2, dtype=torch.int32, device=r0.device)
        ph = torch.zeros((B, len(K7_PHASES) + len(K7_KINDS)), dtype=torch.int64,
                         device=r0.device)
        rc = self.fn(r0.data_ptr(), r1.data_ptr(), stop.data_ptr(), None,
                     *(r.data_ptr() for r in rows), par.data_ptr(), None, work.data_ptr(),
                     B, L, int(mg), 8, ph.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            smoke.fail(f"K7 phases launch failed: cudaError {rc}")
        torch.cuda.synchronize()
        want = self.cgp.lehmer_euclid_cuda(r0, r1, stop, mg)
        if smoke.max_abs_diff(torch, [*rows, par], want):
            smoke.fail(f"{label}: the instrumented K7 disagrees")
        tot = ph.sum(0).tolist()
        cyc, kinds = tot[:len(K7_PHASES)], dict(zip(K7_KINDS, tot[len(K7_PHASES):]))
        groups = max(sum(kinds.values()), 1)
        all_cyc = max(sum(cyc), 1)
        # each phase's cycles over the groups that run it
        runs = {"sim": kinds["sim"], "digit": kinds["digit"], "apply": kinds["sim"],
                "idle": kinds["idle"]}
        lane_cyc = ph[:, :len(K7_PHASES)].sum(1).double()
        smoke.log(f"k7 phases {label}: groups a lane {groups / B:.2f} ("
                  + ", ".join(f"{k} {v / B:.2f}" for k, v in kinds.items())
                  + f"), {all_cyc / groups:.0f} cycles a group; "
                  + "; ".join(f"{k} {c / groups:.0f} a group ({c / all_cyc:.1%})"
                              + (f", {c / max(runs[k], 1):.0f} a {k} group"
                                 if k in runs else "")
                              for k, c in zip(K7_PHASES, cyc))
                  + f"; cycles a lane mean {lane_cyc.mean().item():.0f}, max "
                  f"{lane_cyc.max().item():.0f}")


def k7_sass(smoke, cgp, libs) -> None:
    """SASS of each K7 library's instances at NPT = 5 (compose2's width
    144): instructions in all and by kind; in an instrumented build also
    the instructions between consecutive clock reads, in program order."""
    kinds = ("SHFL", "REDUX", "VOTE", "MUFU", "I2FP", "F2I", "IMAD", "IADD3", "ISETP",
             "FADD", "FMUL", "BRA", "ATOMG", "BAR")
    for label, lib in libs.items():
        for fn, body in sorted(smoke.sass_functions(cgp._nvcc(), lib).items()):
            m = re.search(r"(lehmer_euclid_(?:walk|finish))_kernelILi(\d+)E", fn)
            if not m or m.group(2) != "5":
                continue
            ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                             body, re.M)
            cnt = {k: sum(o == k for o in ops) for k in kinds}
            line = (f"sass {label} {m.group(1)}_kernel<5>: {len(ops)} instructions; "
                    + ", ".join(f"{k} {n}" for k, n in cnt.items()))
            if "clock" in label:
                segs, n = [], 0
                for ln in body.splitlines():
                    if re.search(r"/\*[0-9a-f]{4,}\*/", ln):
                        n += 1
                        if "SR_CLOCKLO" in ln:
                            segs.append(n)
                            n = 0
                line += f"; between clock reads {segs + [n]}"
            smoke.log(line)


def compare_row(torch, smoke, cgp, cg, base, key, args) -> None:
    """This checkout's kernel and the baseline one on one recorded operand:
    agreement, trips, times in turns and bounds (each over its own trips
    and limbs)."""
    name, W, _, B = key
    if name == "lehmer_euclid":
        r0, r1, stop, mg, active = args
        compare_k7(torch, smoke, cgp, base, smoke.row_name(key), B, W, r0, r1, stop, mg,
                   active)
        return
    if name not in base.kernels:
        smoke.log(f"compare {name}[W={W}]@B={B}: the baseline has no such kernel")
        return
    dev = args[0].device
    it_new = torch.zeros(B, dtype=torch.int32, device=dev)
    it_old = torch.zeros_like(it_new)
    tails = ""
    if name == "xgcd_coeff_g":
        f, g, m, nbits = args
        got = cgp.xgcd_coeff_g_cuda(f, g, m, nbits, iters=it_new)
        old = base.xgcd_coeff_g(torch, f, g, m, nbits, iters=it_old)
        if smoke.max_abs_diff(torch, old, got):
            smoke.fail(f"{name}[W={W}]@B={B}: the baseline kernel gives another d or cg")
        new_fn = lambda: cgp.xgcd_coeff_g_cuda(f, g, m, nbits)  # noqa: E731
        old_fn = lambda: base.xgcd_coeff_g(torch, f, g, m, nbits)  # noqa: E731
        steps_new, steps_old = cgp.xgcd2.STEPS, BASELINE_K1_STEPS
        new_ops = float(it_new.long().sum()) * steps_new * W * smoke.OPS_K1
        old_ops = float(it_old.long().sum()) * steps_old * W * smoke.OPS_K1_OLD
        nbytes = 4.0 * B * W * 5
        trips_new = smoke.k1_trips(it_new, steps_new)
        trips_old = smoke.k1_trips(it_old, steps_old)
    elif name == "mod_topdown":
        x, m, max_iters = args
        got = cgp.mod_topdown_cuda(x, m, max_iters, iters=it_new)
        old = base.mod_topdown(torch, x, m, max_iters, iters=it_old)
        if smoke.max_abs_diff(torch, [old], [got]):
            smoke.fail(f"{name}@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.mod_topdown_cuda(x, m, max_iters)  # noqa: E731
        old_fn = lambda: base.mod_topdown(torch, x, m, max_iters)  # noqa: E731
        window = smoke.k2_window(m.shape[1]) * smoke.OPS_K2
        new_ops, old_ops = float(it_new.long().sum()) * window, float(it_old.long().sum()) * window
        nbytes = 4.0 * B * (2 * W + m.shape[1])
        trips_new, trips_old = smoke._stats(it_new), smoke._stats(it_old)
    elif name == "reduce2_grouped":
        a, b, c, dD_mant, dD_top, red_iters = args
        got = cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters,
                                            iters=it_new)
        old = base.reduce2_grouped(torch, a, b, c, dD_mant, dD_top, red_iters,
                                   iters=it_old)
        t_new = torch.zeros_like(it_new)
        t_old = torch.zeros_like(it_new)
        tail_new = cgp.reduce_exact_cuda(*got, cg.tail_iters, iters=t_new)
        tail_old = cgp.reduce_exact_cuda(*old, cg.tail_iters, iters=t_old)
        if smoke.max_abs_diff(torch, tail_old, tail_new):
            smoke.fail(f"{name}@B={B}: the baseline kernel disagrees after the tail")
        new_fn = lambda: cgp.reduce2_grouped_loop_cuda(  # noqa: E731
            a, b, c, dD_mant, dD_top, red_iters)
        old_fn = lambda: base.reduce2_grouped(  # noqa: E731
            torch, a, b, c, dD_mant, dD_top, red_iters)
        new_ops = float(it_new.long().sum()) * W * smoke.OPS_K3
        old_ops = float(it_old.long().sum()) * W * smoke.OPS_K3
        nbytes = 4.0 * B * W * 6
        trips_new, trips_old = smoke._stats(it_new), smoke._stats(it_old)
        tails = (f", exact-tail steps {int(t_new.long().sum())} (baseline "
                 f"{int(t_old.long().sum())})")
    elif name == "mag_mul":
        a, b, Lo = args
        if smoke.max_abs_diff(torch, [base.mag_mul(torch, a, b, Lo)],
                              [cgp.mag_mul_cuda(a, b, Lo)]):
            smoke.fail(f"{name}[W={W}]@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.mag_mul_cuda(a, b, Lo)  # noqa: E731
        old_fn = lambda: base.mag_mul(torch, a, b, Lo)  # noqa: E731
        bnd = smoke.k5m_bound(B, a.shape[-1], b.shape[-1], Lo)
        trips_new = trips_old = (f"{a.shape[-1]}x{b.shape[-1]}, "
                                 f"{smoke.k5m_pairs(a.shape[-1], b.shape[-1], Lo)} limb products")
    elif name == "divexact_odd":
        x, y, Lo = args
        if smoke.max_abs_diff(torch, [base.divexact_odd(torch, x, y, Lo)],
                              [cgp.mag_divexact_odd_cuda(x, y, Lo)]):
            smoke.fail(f"{name}[W={W}]@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.mag_divexact_odd_cuda(x, y, Lo)  # noqa: E731
        old_fn = lambda: base.divexact_odd(torch, x, y, Lo)  # noqa: E731
        bnd = smoke.k5d_bound(B, y.shape[-1], Lo)
        trips_new = trips_old = f"{Lo} digits"
    elif name == "redc_mod":
        x, d, steps, active = args
        if smoke.max_abs_diff(torch, [base.redc_mod(torch, x, d, steps, active)],
                              [cgp.redc_mod_cuda(x, d, steps, active)]):
            smoke.fail(f"{name}[W={W}]@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.redc_mod_cuda(x, d, steps, active)  # noqa: E731
        old_fn = lambda: base.redc_mod(torch, x, d, steps, active)  # noqa: E731
        bnd = smoke.k4_bound(B, W, d.shape[1], steps)
        trips_new = trips_old = (f"{steps} digits, "
                                 f"{B if active is None else int(active.sum())} active lanes")
    else:
        a, b, c, max_iters = args
        got = cgp.reduce_exact_cuda(a, b, c, max_iters, iters=it_new)
        old = base.reduce_exact(torch, a, b, c, max_iters, iters=it_old)
        if smoke.max_abs_diff(torch, old, got):
            smoke.fail(f"{name}@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.reduce_exact_cuda(a, b, c, max_iters)  # noqa: E731
        old_fn = lambda: base.reduce_exact(torch, a, b, c, max_iters)  # noqa: E731
        new_ops = float(it_new.long().sum()) * W * smoke.OPS_KT
        old_ops = float(it_old.long().sum()) * W * smoke.OPS_KT
        nbytes = 4.0 * B * (6 * W + 2)
        trips_new, trips_old = smoke._stats(it_new), smoke._stats(it_old)
    ms, old_ms, t, reps = in_turns(torch, smoke, new_fn, old_fn)
    if name in ("mag_mul", "divexact_odd", "redc_mod"):
        bms = old_bms = bnd[0]
    else:
        bms, old_bms = smoke.bound(new_ops, nbytes)[0], smoke.bound(old_ops, nbytes)[0]
    smoke.log(f"compare {name}[W={W}]@B={B}: this kernel {ms:.4f} ms (trips "
              f"{trips_new}, bound {bms:.5f} ms, {bms / ms:.1%} of it), "
              f"baseline {old_ms:.4f} ms (trips {trips_old}, bound "
              f"{old_bms:.5f} ms, {old_bms / old_ms:.1%} of it), {old_ms / ms:.2f}x; "
              f"turns {t['old'][0]:.4f} {t['new'][0]:.4f} {t['new'][1]:.4f} "
              f"{t['old'][1]:.4f} ms, {reps} calls each" + tails)


def sass_compare(smoke, cgp, base) -> None:
    """SASS counts (smoke.SASS_OPS) of each K5m and KT instance, this
    checkout's and the baseline's."""
    for label, path in (("this checkout", cgp._lib_path),
                        ("baseline", lambda n: os.path.join(base.out_dir, f"lib{n}.so"))):
        for name in ("mag_mul", "reduce_exact"):
            if label == "baseline" and name not in base.kernels:
                continue
            for fn, body in sorted(smoke.sass_functions(cgp._nvcc(), path(name)).items()):
                inst = smoke.kernel_instance(fn)
                if inst is not None:
                    cnt = smoke.sass_counts(body)
                    smoke.log(f"sass {label} {inst[0]}_kernel<{', '.join(map(str, inst[1]))}>: "
                              + ", ".join(f"{op} {n}" for op, n in cnt.items()))


TREE_B = (128, 256, 16384)   # compose2 batches timed by replay
DECRYPT_STEPS = 1285         # compose2 steps of the main path's decrypt


def compose_turn(root: str) -> int:
    """One turn of --baseline-tree, in a process of its own: the package
    of the checkout `root`, profiled and timed with this checkout's
    chip_smoke.py; the last line is a JSON object of the times."""
    import importlib.util

    sys.path.insert(0, root)
    import torch

    import cofhe_tpu_torch

    if not os.path.abspath(cofhe_tpu_torch.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"kernel_compare: cofhe_tpu_torch does not come from {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke_this",
                                                  os.path.join(_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops import cuda_group, hostgmp
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms import bform_from_forms

    cuda_group.build()
    hsm = CLHSM2k(smoke.SEC, smoke.K)
    cg = TorchEngine(hsm, "cuda").cg
    ecg = smoke.eager_cg(TorchEngine(hsm, "cuda").cg)
    gmp = hostgmp.GmpClassGroup(hsm.Delta)
    label = f"tree {root}"
    smoke.profile_compose(torch, cg, gmp, hsm, bform_from_forms, random.Random(smoke.SEED),
                          f"{label}, graph replay")
    smoke.profile_compose(torch, ecg, gmp, hsm, bform_from_forms, random.Random(smoke.SEED),
                          f"{label}, eager", sections=True)
    rng = random.Random(smoke.SEED + 1)
    base = gmp.nupow_batch([hsm.h] * 16, [rng.getrandbits(1100) for _ in range(16)])
    out = {"root": root}
    with torch.inference_mode():
        for B in TREE_B:
            b1 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
            b2 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
            cg.compose2(b1, b2)
            out[f"replay_ms@{B}"] = smoke.timed(torch, lambda: cg.compose2(b1, b2),
                                                5 if B == 16384 else 50)
            if B == 128:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(DECRYPT_STEPS):
                    cg.compose2(b1, b2)
                torch.cuda.synchronize()
                out[f"{DECRYPT_STEPS}_replays_s@128"] = time.perf_counter() - t
    smoke.log(json.dumps(out))
    return 0


def tree_turns(smoke, tree: str) -> None:
    """compose2 of this checkout against the checkout `tree`, in turns
    (tree, this, this, tree), a process a turn (compose_turn)."""
    runs: dict = {"baseline": [], "this": []}
    for who in ("baseline", "this", "this", "baseline"):
        root = os.path.abspath(tree) if who == "baseline" else _ROOT
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--compose-turn", root],
                           capture_output=True, text=True, timeout=900)
        for ln in p.stdout.splitlines():
            smoke.log(f"[{who}] {ln}")
        if p.returncode:
            smoke.fail(f"the {who} turn failed:\n{p.stderr[-3000:]}")
        runs[who].append(json.loads(p.stdout.strip().splitlines()[-1]))
    for key in [k for k in runs["this"][0] if k != "root"]:
        new, old = [r[key] for r in runs["this"]], [r[key] for r in runs["baseline"]]
        smoke.log(f"compose2 {key}: this checkout {new[0]:.4f} / {new[1]:.4f}, baseline "
                  f"{old[0]:.4f} / {old[1]:.4f} ({sum(old) / sum(new):.2f}x)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc",
                    help="a csrc/ directory with the earlier kernel sources")
    ap.add_argument("--baseline-tree",
                    help="another checkout: its compose2 against this one's, in turns")
    ap.add_argument("--compose-turn", help=argparse.SUPPRESS)
    ap.add_argument("--k7-phases", action="store_true",
                    help="K7 only: its time beside the baseline's on compose2 walk "
                    "operands at 128, 1001 and 16384 lanes, the split of a group's "
                    "cycles by phase (builds with -DK7_PHASES, of the baseline too "
                    "where its source has the hooks) and SASS counts")
    opts = ap.parse_args()
    if opts.compose_turn:
        return compose_turn(opts.compose_turn)
    if not (opts.baseline_csrc or opts.baseline_tree):
        ap.error("give --baseline-csrc or --baseline-tree")
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _ROOT)
    import chip_smoke as smoke

    if opts.baseline_tree:
        smi = smoke.card_line()
        smoke.log(smi)
        tree_turns(smoke, opts.baseline_tree)
        smoke.log(smi)
        return 0
    port = smoke.import_port()
    if port is None:
        return 1
    cgp = port.cgp
    smi = smoke.card_line()
    smoke.log(smi)
    if port.hostgmp.get_lib() is None:
        smoke.fail("the GMP host backend (g++ + libgmp) did not build")
    base = Baseline(opts.baseline_csrc, cgp, smoke.fail)
    if opts.k7_phases:
        base.kernels = [n for n in base.kernels if n == "lehmer_euclid"]
    base.start()
    phases = {}
    if opts.k7_phases:
        for who, csrc in (("this checkout", cgp.CSRC_DIR), ("baseline", opts.baseline_csrc)):
            if PhaseLib.has_hooks(csrc):
                phases[who] = PhaseLib(cgp, csrc, os.path.join(
                    base.out_dir, f"liblehmer_euclid_phases_{who.split()[0]}.so"))
    cgp.build()
    base.finish()
    for lib in phases.values():
        lib.finish(smoke.fail)
    smoke.report_build(cgp)
    smoke.log(f"baseline kernels built from {opts.baseline_csrc}")

    rng = random.Random(smoke.SEED)
    hsm = port.CLHSM2k(smoke.SEC, smoke.K)
    cg = port.TorchEngine(hsm, "cuda").cg
    gmp = port.hostgmp.GmpClassGroup(hsm.Delta)
    if opts.k7_phases:
        libs = {"this checkout": cgp._lib_path("lehmer_euclid")}
        if "lehmer_euclid" in base.kernels:
            libs["baseline"] = os.path.join(base.out_dir, "liblehmer_euclid.so")
        libs.update({f"{who} clock": lib.out for who, lib in phases.items()})
        k7_sass(smoke, cgp, libs)
        k7_walk(torch, smoke, cgp, port, base, hsm, cg, gmp, rng, phases)
        smoke.log(smi)
        return 0
    sass_compare(smoke, cgp, base)
    from cofhe_tpu_torch.ops import graphs
    from cofhe_tpu_torch.tools import mesh_check

    smoke.CALLS = mesh_check.count_calls(cgp, graphs)  # as chip_smoke.main does
    rec = smoke.Recorder(torch, cgp)
    _, _, main_path = smoke.run_slice(torch, cgp, rec, port.CryptoSystem, port.Tensor,
                                      port.hostgmp.GmpEngine, rng)
    smoke.compare_decrypt(torch, cgp, port, rec, main_path)
    matmul_again(torch, smoke, cgp, base, main_path)
    ops = dict(rec.ops)
    ops.update(nucomp_operands(torch, smoke, cgp, port, main_path))
    with torch.inference_mode():
        for key in sorted(ops, key=lambda k: (k[3], k[0], k[1])):
            compare_row(torch, smoke, cgp, cg, base, key, ops[key])
        compare_synthetic(torch, smoke, cgp, port, base, cg, gmp, hsm, rng)
    k7_walk(torch, smoke, cgp, port, base, hsm, cg, gmp, rng)
    ecg = smoke.eager_cg(port.TorchEngine(hsm, "cuda").cg)
    smoke.profile_compose(torch, ecg, gmp, hsm, port.bform_from_forms, rng,
                          "this checkout's kernels, eager")
    with baseline_in_place(torch, cgp, base):
        smoke.profile_compose(torch, ecg, gmp, hsm, port.bform_from_forms, rng,
                              "baseline kernels, eager")
    smoke.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
