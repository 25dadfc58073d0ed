#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (cofhe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py       # from the root of a checkout

1. Builds the Hopper kernels from cofhe_tpu_torch/csrc with nvcc and holds
   each one against its plain torch version on the card, at the shapes the
   main path gives it and at 128, 1001 and 16384 lanes (bit-exact, and
   against Python integers and GMP), timing both; K2 also on the edge cases
   of its wide digit.
2. Drives the main path once at sec=128, k=128 through the facade:
   keygen, encrypt_tensor ct(2x64), scal_ciphertext_tensors with pt(64x64)
   (16384 ladder lanes), decrypt_tensor; every plaintext must equal the
   integer matmul mod 2^128, every kernel's launch counter must have grown,
   and two output ciphertexts must be bit-identical to the GMP host
   backend's for the same inputs and Enc(0). Wrappers around the three
   kernels count each kernel's launches by shape and batch and record the
   operands of one decrypt compose2 (128 lanes), one chain compose2 (256)
   and one ladder compose2 (16384). K1 is then checked again, with and
   without need_u, on the recorded decrypt lanes whose gcd is above 1
   (there cg is not unique mod m: only the reference's divstep sequence
   gives it).
3. The kernel table: every kernel at every recorded main-path shape and
   batch, checked against its plain versions (K1 also against Python's
   gcd and the Bezout identity), with its trip counts (K1 in groups and
   in divsteps), time and bound (also at the earlier kernels' per-limb
   operation counts: the 13-divstep K1, the 24-bit-digit K2, the
   2^12-budget K3); the device time of one compose2 at 128 lanes split by
   kernel.
4. Prints the card's name and power limit, one JSON line with each
   kernel's numbers, and as the last line {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. It needs CUDA and
the rest of the repository; without either it exits non-zero and prints no
result. `python3 -m cofhe_tpu_torch.tools.kernel_compare` times an
earlier csrc/'s kernels beside this tree's on the same recorded operands.
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import subprocess
import sys
import time

SEED = 20261016
SEC, K = 128, 128
N_ROWS, M_INNER, P_COLS = 2, 64, 64
KERNEL_B = 16384   # lanes of one matmul ladder chunk
RAGGED_B = 1001
SMALL_B = 128      # lanes of a decrypt step
TABLE_B = (128, 256, 16384)  # decrypt, chain, ladder compose2 batches
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the int32 rate as half
# the FP32 lanes of the 67 TFLOP/s float32 figure, one op per lane per clock
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
# int32 operations per limb of one loop iteration, counted from the kernel
# sources (products, sums, shifts, masks; a carry pass counts 5, a value
# estimate 4, a 64-bit add or shift 2). K1 per divstep and limb: a
# 30-divstep group does 83 a limb (f, g: 4 int64 products and sums, two
# shifts by 2^30 (6 each), two 16-bit splits (3 each) and carry passes,
# the zero test; Q, S: 6 products and sums with the m term, the same
# normalization, two sign keys) and 46 more with need_u; the scalar
# divstep chain (20 ops a step, once a lane) is not counted. K2 per
# iteration and window limb (32 * ceil((Lm + 3) / 32) limbs: load, 64-bit
# product and subtraction, 3-digit spread, carry pass, store, value
# estimate); K3 per group and limb (9 int64 products and sums, three
# 4-digit spreads and carry passes, two top-word estimates). The table
# also gives each bound at the earlier kernels' counts over the new
# kernels' trips and limbs: K1 108 a 13-divstep group and limb (higher
# than the new count a divstep, so that bound is the larger), 24-bit-digit
# K2 20 and 2^12-budget K3 74 (lower: they leave out the redesigns' extra
# carry pass, value estimates and wider spreads).
OPS_K1, OPS_K1_U, OPS_K2, OPS_K3 = 83 / 30, 46 / 30, 36, 147
OPS_K1_OLD, OPS_K2_OLD, OPS_K3_OLD = 108 / 13, 20, 74
TIMING_REPS = 5


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(ops: float, nbytes: float):
    t_ops, t_mem = ops / INT32_OPS_PER_S, nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def timed(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call over `reps` calls, timed with CUDA events. With
    `warm`, one call first, and then a spin kernel queued ahead of the
    timed calls keeps the card busy while the host queues them, so that a
    wrapper's host time does not count beside a short kernel (a kernel of
    ~0.1 ms at 128 lanes is about as long as one Python wrapper call).
    Without it (the plain versions, which wait on the card), the calls'
    wall time on the card's clock."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        # cycles at <= 2 GHz for 1.5x the queueing time, plus 1 ms
        torch.cuda._sleep(int(((time.perf_counter() - t0) * 1.5 * reps + 1e-3) * 2e9))
    else:
        torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(torch, xs, ys) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(xs, ys))


def k2_window(Lm: int) -> int:
    """Limbs K2 sweeps an iteration: 32 threads x ceil((Lm + 3) / 32)."""
    return 32 * ((Lm + 3 + 31) // 32)


# ------------------------------------------------------------ kernel checks


def k1_oracle(lb, name, fs, gs, got, need_u) -> int:
    """K1's outputs against Python's gcd and the Bezout identity (m = f);
    returns the number of lanes with d > 1."""
    d, cg = lb.limbs_to_ints(got[0].cpu()), lb.limbs_to_ints(got[1].cpu())
    cu = lb.limbs_to_ints(got[2].cpu()) if need_u else None
    for i, (f, g) in enumerate(zip(fs, gs)):
        if d[i] != math.gcd(f, g) or not 0 <= cg[i] < f \
                or (cg[i] * g - d[i]) % f:
            fail(f"{name} lane {i}: gcd/Bezout wrong")
        if need_u and (cu[i] * f + cg[i] * g - d[i]) % f:
            fail(f"{name} lane {i}: need_u Bezout wrong")
    return sum(x > 1 for x in d)


def k1_trips(iters, steps: int) -> str:
    """K1's trips in groups of `steps` divsteps and in divsteps."""
    return (f"groups {_stats(iters)}, divsteps mean "
            f"{steps * float(iters.float().mean()):.1f} max {steps * int(iters.max())}")


def check_k1(torch, cgp, lb, rng, W, nbits, need_u, B, op_bits, extra=()):
    """K1 vs its plain version and Python's gcd / Bezout identity; `extra`
    (f, g) pairs take the lanes after the edge cases."""
    dev = "cuda"
    fs = [rng.getrandbits(rng.randrange(op_bits // 2, op_bits + 1)) | 1
          for _ in range(B)]
    gs = [rng.getrandbits(rng.randrange(1, op_bits + 1)) for _ in range(B)]
    k = rng.getrandbits(op_bits // 3) | 1
    edge = [(1, 0), (1, 5), (3, 0), (3, 6), (k * 9, k * 6),
            ((1 << (op_bits - 1)) + 1, 2), (fs[0], fs[0]), (fs[1], 0),
            (fs[2], fs[2] * 7)]
    for i, (f, g) in enumerate(edge + list(extra)[:B - len(edge)]):
        fs[i], gs[i] = f, g
    f = torch.as_tensor(lb.ints_to_limbs(fs, W)).to(dev)
    g = torch.as_tensor(lb.ints_to_limbs(gs, W)).to(dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    got = cgp.xgcd_coeff_g_cuda(f, g, f, nbits, need_u=need_u, iters=iters)
    torch.cuda.synchronize()
    plain = cgp.xgcd_coeff_g_plain(f, g, f, nbits, need_u=need_u)
    err = max_abs_diff(torch, got, plain)
    if err:
        fail(f"K1 W={W} B={B} differs from its plain version (max {err})")
    n_d = k1_oracle(lb, f"K1 W={W}", fs, gs, got, need_u)
    ms = timed(torch, lambda: cgp.xgcd_coeff_g_cuda(f, g, f, nbits, need_u), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.xgcd_coeff_g_plain(f, g, f, nbits, need_u),
                     1, warm=False) if B == KERNEL_B else float("nan")
    per_limb = OPS_K1 + (OPS_K1_U if need_u else 0)
    ops = float(iters.long().sum()) * cgp.xgcd2.STEPS * W * per_limb
    nbytes = 4.0 * B * W * (3 + (3 if need_u else 2))
    bms, by = bound(ops, nbytes)
    log(f"K1 xgcd_coeff_g W={W} nbits={nbits} need_u={need_u} B={B}: "
        f"bit-exact, oracle ok ({n_d} lanes with d > 1, {len(extra)} of them "
        f"given); {k1_trips(iters, cgp.xgcd2.STEPS)}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


def k2_operands(lb, rng, B, edge_cases: bool):
    """Signed x (B, 264) and even m (B, 144) of the mu reduction's widths;
    with edge_cases the first lanes hold the wide digit's edge cases:
    x = +-k*m, x = m - 1, x at the top of what the 264 limbs are sized for
    (2D + 34 bits, D = 2085, the JAX package's Lm), and j clipped at
    L - 2 - top_m (a tiny m under a 264-limb x)."""
    Lx, Lm = 264, 144
    xs = [rng.getrandbits(rng.randrange(2000, 4150)) * rng.choice((1, -1))
          for _ in range(B)]
    ms_ = [rng.getrandbits(rng.randrange(1000, 2080)) * 2 + 2 for _ in range(B)]
    edge = [(0, 2), (-1, 2), ((1 << 630) - 1, 3), (ms_[3], ms_[3]),
            (-ms_[4], ms_[4]), ((1 << 4150) - 1, 2), (ms_[6] - 1, ms_[6])]
    if edge_cases:
        k = rng.getrandbits(2000) | 1
        full = (1 << (2 * 2085 + 34)) - 1
        top = (1 << (16 * 263 + 15)) - 1
        edge += [(k * ms_[7], ms_[7]), (-k * ms_[8], ms_[8]), (ms_[9] - 1, ms_[9]),
                 (full, ms_[10]), (-full, ms_[11]), (full, (1 << 2079) + 2),
                 (top, 2), (-top, 6), (top, 1)]
    for i, (x, m) in enumerate(edge):
        xs[i], ms_[i] = x, m
    sx, mx = lb.ints_to_signed(xs, Lx)
    return xs, ms_, sx[:, None] * mx, lb.ints_to_limbs(ms_, Lm)


def check_k2(torch, cgp, lb, rng, B, edge_cases=False):
    """K2 on the mu reduction's shapes: x (B, 264) signed, m (B, 144) even;
    bit-exact against its plain version, rl.mod_topdown and x % m."""
    dev = "cuda"
    max_iters = 378
    xs, ms_, xl, ml = k2_operands(lb, rng, B, edge_cases)
    x, m = torch.as_tensor(xl).to(dev), torch.as_tensor(ml).to(dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    got = cgp.mod_topdown_cuda(x, m, max_iters, iters=iters)
    torch.cuda.synchronize()
    plain = cgp.mod_topdown_plain(x, m, max_iters)
    err = max_abs_diff(torch, [got], [plain])
    if err:
        fail(f"K2 B={B} differs from its plain version (max {err})")
    if max_abs_diff(torch, [got], [cgp.rl.mod_topdown(x, m, max_iters=max_iters)]):
        fail(f"K2 B={B} differs from rl.mod_topdown")
    vals = lb.limbs_to_ints(got)
    for i in range(B):
        if vals[i] != xs[i] % ms_[i]:
            fail(f"K2 lane {i}: x mod m wrong")
    ms = timed(torch, lambda: cgp.mod_topdown_cuda(x, m, max_iters), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.mod_topdown_plain(x, m, max_iters), 1,
                     warm=False) if B == KERNEL_B else float("nan")
    ops = float(iters.long().sum()) * k2_window(m.shape[1]) * OPS_K2
    bms, by = bound(ops, 4.0 * B * (2 * x.shape[1] + m.shape[1]))
    log(f"K2 mod_topdown Lx={x.shape[1]} Lm={m.shape[1]} B={B}"
        f"{' with edge cases' if edge_cases else ''}: bit-exact vs plain, "
        f"rl.mod_topdown and x % m; iterations mean {float(iters.float().mean()):.1f} "
        f"max {int(iters.max())}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


def check_k3(torch, cgp, cg, f2m, gmp, hsm, bform_from_forms, bform_to_forms, rng, B):
    """K3 on the unreduced compose outputs of B random form pairs: its raw
    limbs must equal its plain version's, and after the exact tail it must
    give grouped_rho_loop's forms and GMP's composes."""
    base = gmp.nupow_batch([hsm.h] * 64, [rng.getrandbits(1100) for _ in range(64)])
    f1 = [base[rng.randrange(64)] for _ in range(B)]
    f2 = [base[rng.randrange(64)] for _ in range(B)]
    f1[0] = f2[0]                      # a self-compose (nudupl)
    b1 = bform_from_forms(f1, cg.L, "cuda")
    b2 = bform_from_forms(f2, cg.L, "cuda")
    with torch.inference_mode():
        a3, b3s, b3m, c3, _, _ = cg.compose2_unreduced(b1, b2)
        bred = b3s[..., None] * b3m
        args = (cg.dD_mant, cg.dD_top, cg.red_iters)
        iters = torch.zeros(B, dtype=torch.int32, device="cuda")
        raw = cgp.reduce2_grouped_loop_cuda(a3, bred, c3, *args, iters=iters)
        raw_plain = cgp.reduce2_grouped_loop_plain(a3, bred, c3, *args)
        err = max_abs_diff(torch, raw, raw_plain)
        if err:
            fail(f"K3 B={B}: limbs differ from the plain version (max {err})")
        got = cg._tail(*raw)
        if max_abs_diff(torch, got, cg._tail(*f2m.grouped_rho_loop(a3, bred, c3, *args))):
            fail(f"K3 B={B}: reduced forms differ from grouped_rho_loop's")
        want = gmp.compose_batch(f1[:256], f2[:256])
        if bform_to_forms(got)[:256] != want:
            fail(f"K3 B={B}: reduced forms differ from GMP's composes")
        ms = timed(torch, lambda: cgp.reduce2_grouped_loop_cuda(a3, bred, c3, *args),
                   TIMING_REPS)
        plain_ms = timed(torch, lambda: cgp.reduce2_grouped_loop_plain(
            a3, bred, c3, *args), 1, warm=False) if B == KERNEL_B else float("nan")
    L = a3.shape[1]
    ops = float(iters.long().sum()) * L * OPS_K3
    bms, by = bound(ops, 4.0 * B * L * 6)
    log(f"K3 reduce2_grouped L={L} B={B}: limbs equal to the plain version, "
        f"tail-exact vs grouped_rho_loop and GMP; groups "
        f"mean {float(iters.float().mean()):.1f} max {int(iters.max())}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


# ------------------------------------------- main-path operands and launches


class Recorder:
    """Wraps the three kernel wrappers of cuda_group for the main path's
    run: counts each kernel's launches by (name, width, nbits, batch) and
    keeps the operands of the first call at each shape in the chosen
    (phase, batch) pairs. Not part of the package; removed after the run."""

    WANT = {("decrypt", 128), ("matmul", 256), ("matmul", 16384)}

    def __init__(self, torch, cgp):
        self.torch, self.cgp = torch, cgp
        self.phase = None
        self.counts: dict = {}
        self.ops: dict = {}
        self.orig = {n: getattr(cgp, n) for n in (
            "xgcd_coeff_g_cuda", "mod_topdown_cuda", "reduce2_grouped_loop_cuda")}

    def _note(self, key, B, args):
        full = key + (B,)
        self.counts[full] = self.counts.get(full, 0) + 1
        if (self.phase, B) in self.WANT and full not in self.ops:
            self.ops[full] = tuple(a.clone() if isinstance(a, self.torch.Tensor)
                                   else a for a in args)

    def __enter__(self):
        rec, orig = self, self.orig

        def xgcd(f, g, m, nbits, need_u=False, iters=None):
            rec._note(("xgcd_coeff_g", f.shape[1], nbits), f.shape[0], (f, g, m, nbits))
            return orig["xgcd_coeff_g_cuda"](f, g, m, nbits, need_u=need_u, iters=iters)

        def mod(x, m, max_iters, iters=None):
            rec._note(("mod_topdown", x.shape[1], m.shape[1]), x.shape[0],
                      (x, m, max_iters))
            return orig["mod_topdown_cuda"](x, m, max_iters, iters=iters)

        def red(a, b, c, dD_mant, dD_top, red_iters, iters=None):
            rec._note(("reduce2_grouped", a.shape[1], 0), a.shape[0],
                      (a, b, c, dD_mant, dD_top, red_iters))
            return orig["reduce2_grouped_loop_cuda"](a, b, c, dD_mant, dD_top,
                                                     red_iters, iters=iters)

        self.cgp.xgcd_coeff_g_cuda = xgcd
        self.cgp.mod_topdown_cuda = mod
        self.cgp.reduce2_grouped_loop_cuda = red
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cgp, n, fn)
        return False


# ---------------------------------------------------------------- the path


def run_slice(torch, cgp, rec, CryptoSystem, Tensor, GmpEngine, rng):
    """encrypt -> homomorphic matmul -> decrypt at sec=128, k=128."""
    phases = {}
    t0 = time.perf_counter()
    cs = CryptoSystem(SEC, K, device="cuda", seed=b"chip-smoke")
    sk = cs.keygen()
    pk = cs.keygen(sk)
    M = cs.hsm2k.M
    phases["setup_keygen_s"] = time.perf_counter() - t0
    ctv = [rng.randrange(M) for _ in range(N_ROWS * M_INNER)]
    sv = [rng.randrange(M) for _ in range(M_INNER * P_COLS)]
    pt = Tensor(sv, (M_INNER, P_COLS))

    cgp.reset_launches()
    with rec:
        rec.phase = "encrypt"
        t = time.perf_counter()
        ct = cs.encrypt_tensor(pk, Tensor(ctv, (N_ROWS, M_INNER)))
        torch.cuda.synchronize()
        phases["encrypt_s"] = time.perf_counter() - t
        # the facade draws the matmul's Enc(0) from its generator: a copy of
        # the generator replays it for the host check below
        rand_at_matmul = copy.deepcopy(cs.rand_gen)
        rec.phase = "matmul"
        t = time.perf_counter()
        with TailCount() as tail:
            res = cs.scal_ciphertext_tensors(pk, pt, ct)
            torch.cuda.synchronize()
        phases["matmul_s"] = time.perf_counter() - t
        phases["matmul_tail_iters"] = tail.n
        phases.update({f"matmul_{k}": v
                       for k, v in cs._engine.last_matmul_phases.items()})
        rec.phase = "decrypt"
        t = time.perf_counter()
        with TailCount() as tail:
            dec = cs.decrypt_tensor(sk, res)
            torch.cuda.synchronize()
        phases["decrypt_s"] = time.perf_counter() - t
        phases["decrypt_tail_iters"] = tail.n
    launches = dict(cgp.LAUNCHES)

    for i in range(N_ROWS):
        for kk in range(P_COLS):
            want = sum(ctv[i * M_INNER + j] * sv[j * P_COLS + kk]
                       for j in range(M_INNER)) % M
            if dec.at(i, kk) != want:
                fail(f"decrypted ({i}, {kk}) != integer matmul mod 2^{K}")
    from cofhe_tpu_torch.core.qfi import is_reduced

    if not all(is_reduced(f) for c in res.data for f in c):
        fail("a matmul output form is not reduced")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for name, n in launches.items():
        if sum(v for k, v in rec.counts.items() if k[0] == name) != n:
            fail(f"the recorder's count of {name} disagrees with LAUNCHES")

    # bit-identity with the GMP host backend: ct row 0 x pt[:, :2] with the
    # same Enc(0) must give the main path's res[0, 0] and res[0, 1]
    t = time.perf_counter()
    zero = cs.hsm2k.encrypt(pk, 0, copy.deepcopy(rand_at_matmul))
    row0 = Tensor([ct.at(0, j) for j in range(M_INNER)], (1, M_INNER))
    pt2 = Tensor([sv[j * P_COLS + kk] for j in range(M_INNER) for kk in range(2)],
                 (M_INNER, 2))
    host_out = GmpEngine(cs.hsm2k).scal_matmul(pt2, row0, zero)
    if list(host_out.data) != [res.at(0, 0), res.at(0, 1)]:
        fail("matmul ciphertexts differ from the GMP host backend's")
    phases["gmp_check_s"] = time.perf_counter() - t
    log(f"slice ct({N_ROWS}x{M_INNER}) x pt({M_INNER}x{P_COLS}) at sec={SEC} k={K}: "
        f"{N_ROWS * P_COLS} plaintexts correct, every output form reduced, "
        f"2 ciphertexts bit-identical to GMP")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    log("main-path launches: " + json.dumps(launches))
    slice_args = (cs, pk, pt, ct, res, rand_at_matmul)
    log("main-path launches by (kernel, width, nbits or Lm, batch): " + json.dumps(
        {",".join(map(str, k)): v for k, v in sorted(rec.counts.items())}))
    return launches, slice_args


# --------------------------------------------------------- the kernel table


def _stats(t) -> str:
    return f"mean {float(t.float().mean()):.2f} max {int(t.max())}"


class TailCount:
    """Counts the iterations of the exact tail (forms.reduce_batch calls
    forms._is_reduced once an iteration) inside a with block."""

    def __enter__(self):
        from cofhe_tpu_torch.ops import forms

        self.forms, self.orig, self.n = forms, forms._is_reduced, 0

        def counted(bf):
            self.n += 1
            return self.orig(bf)

        forms._is_reduced = counted
        return self

    def __exit__(self, *exc):
        self.forms._is_reduced = self.orig
        return False


def table_row(torch, cgp, f2m, cg, lb, key, args, n_launch):
    """One kernel at one recorded main-path shape and batch: checks, trip
    counts, time and bound. Returns its JSON entry."""
    name, W, extra, B = key
    dev = args[0].device
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    row = {"name": f"{name}[W={W},{'nbits' if name == 'xgcd_coeff_g' else 'Lm'}="
                   f"{extra}]@B={B}" if name != "reduce2_grouped" else f"{name}@B={B}",
           "launches": n_launch, "library_ms": None}
    old_ops = None
    if name == "xgcd_coeff_g":
        f, g, m, nbits = args
        got = cgp.xgcd_coeff_g_cuda(f, g, m, nbits, iters=iters)
        row["max_abs_err"] = max_abs_diff(torch, got, cgp.xgcd_coeff_g_plain(f, g, m, nbits))
        if not torch.equal(f, m):
            fail(f"{row['name']}: the recorded call does not pass m = f")
        row["d_gt_1_lanes"] = k1_oracle(lb, row["name"], lb.limbs_to_ints(f.cpu()),
                                        lb.limbs_to_ints(g.cpu()), got, False)
        fn = lambda: cgp.xgcd_coeff_g_cuda(f, g, m, nbits)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.xgcd_coeff_g_plain(f, g, m, nbits), 1,
                         warm=False)
        steps = float(iters.long().sum()) * cgp.xgcd2.STEPS * W
        ops, old_ops = steps * OPS_K1, steps * OPS_K1_OLD
        nbytes = 4.0 * B * W * 5
    elif name == "mod_topdown":
        x, m, max_iters = args
        got = cgp.mod_topdown_cuda(x, m, max_iters, iters=iters)
        plain = cgp.mod_topdown_plain(x, m, max_iters)
        row["max_abs_err"] = max_abs_diff(torch, [got], [plain])
        # x is signed redundant: its value, then x % m on Python integers
        sg, mag = lb.canonicalize_fast(x.cpu())
        xs = [int(s) * v for s, v in zip(sg.tolist(), lb.limbs_to_ints(mag))]
        if lb.limbs_to_ints(got.cpu()) != [a % b for a, b in zip(xs, lb.limbs_to_ints(m.cpu()))]:
            fail(f"{row['name']}: x mod m wrong on the recorded operands")
        fn = lambda: cgp.mod_topdown_cuda(x, m, max_iters)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.mod_topdown_plain(x, m, max_iters), 1,
                         warm=False)
        limbs = float(iters.long().sum()) * k2_window(m.shape[1])
        ops, old_ops = limbs * OPS_K2, limbs * OPS_K2_OLD
        nbytes = 4.0 * B * (2 * W + m.shape[1])
    else:
        a, b, c, dD_mant, dD_top, red_iters = args
        got = cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters, iters=iters)
        plain = cgp.reduce2_grouped_loop_plain(a, b, c, dD_mant, dD_top, red_iters)
        row["max_abs_err"] = max_abs_diff(torch, got, plain)
        with TailCount() as tc:
            tail = cg._tail(*got)
        row["tail_iters"] = tc.n
        if max_abs_diff(torch, tail, cg._tail(*f2m.grouped_rho_loop(
                a, b, c, dD_mant, dD_top, red_iters))):
            fail(f"{row['name']}: differs from grouped_rho_loop after the tail")
        fn = lambda: cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.reduce2_grouped_loop_plain(
            a, b, c, dD_mant, dD_top, red_iters), 1, warm=False)
        limbs = float(iters.long().sum()) * W
        ops, old_ops = limbs * OPS_K3, limbs * OPS_K3_OLD
        nbytes = 4.0 * B * W * 6
    if row["max_abs_err"]:
        fail(f"{row['name']}: differs from its plain version")
    ms = timed(torch, fn, TIMING_REPS)
    bms, by = bound(ops, nbytes)
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               trips=k1_trips(iters, cgp.xgcd2.STEPS) if name == "xgcd_coeff_g" else _stats(iters))
    if old_ops is not None:
        row["bound_old_counts_ms"] = bound(old_ops, nbytes)[0]
    log(f"table {row['name']}: launches {n_launch}, trips {row['trips']}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bms:.5f} ms ({by}, "
        f"{bms / ms:.1%} of it)"
        + (f", bound at the earlier per-limb counts {row['bound_old_counts_ms']:.5f} ms "
           f"({row['bound_old_counts_ms'] / ms:.1%} of it)" if old_ops is not None else "")
        + (f", exact-tail iterations {row['tail_iters']}" if "tail_iters" in row else "")
        + (f", oracle ok, {row['d_gt_1_lanes']} lanes with d > 1"
           if "d_gt_1_lanes" in row else ""))
    return row


def decrypt_k1_lanes(lb, rec):
    """(W, nbits, [(f, g), ...]) of the recorded decrypt K1 calls' lanes
    with gcd(f, g) > 1 (nudupl steps: a1 = a2)."""
    out = []
    for (name, W, nbits, B), args in sorted(rec.ops.items()):
        if name == "xgcd_coeff_g" and B == SMALL_B:
            pairs = [(f, g) for f, g in zip(lb.limbs_to_ints(args[0].cpu()),
                                            lb.limbs_to_ints(args[1].cpu()))
                     if math.gcd(f, g) > 1]
            if pairs:
                out.append((W, nbits, pairs))
    return out


def profile_compose(torch, cg, gmp, hsm, bform_from_forms, rng, label, B=128):
    """Host wall time and device time of one compose2 at the decrypt
    ladder's batch (the device's busy share of a host-driven step), the
    device time split into the three kernels and everything else, and the
    iterations of the exact tail (forms.reduce_batch) after the rho loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    base = gmp.nupow_batch([hsm.h] * 16, [rng.getrandbits(1100) for _ in range(16)])
    b1 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
    b2 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
    with torch.inference_mode():
        cg.compose2(b1, b2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cg.compose2(b1, b2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cg.compose2(b1, b2)
            torch.cuda.synchronize()
        with TailCount() as tail:
            cg.compose2(b1, b2)
    # device-side events only: a CPU op's device time repeats its kernels'
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    split = {"xgcd_coeff_g": 0.0, "mod_topdown": 0.0, "reduce2_grouped": 0.0, "other": 0.0}
    for e in device:
        k = next((n for n in split if n + "_kernel" in e.name), "other")
        split[k] += e.self_device_time_total / 1e3
    dev_ms = sum(split.values())
    busy = f"{dev_ms / wall_ms:.1%} of the wall time" if dev_ms else "not measured"
    log(f"compose2 B={B} ({label}): wall {wall_ms:.1f} ms, device {dev_ms:.2f} ms "
        f"({busy}), {len(device)} device kernels and copies, {tail.n} exact-tail "
        f"iterations; device ms by kernel " + json.dumps({k: round(v, 3) for k, v in split.items()}))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def import_port():
    """The port's modules from this checkout, or None (with a message on
    stderr) when the package is missing or comes from elsewhere."""
    from types import SimpleNamespace

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import cofhe_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the cofhe_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return None
    if not os.path.abspath(cofhe_tpu_torch.__file__).startswith(here + os.sep):
        print("chip_smoke: cofhe_tpu_torch does not come from this checkout",
              file=sys.stderr)
        return None
    from cofhe_tpu_torch.api import CryptoSystem
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops import cuda_group, forms2, hostgmp, limb
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
    from cofhe_tpu_torch.tensor import Tensor

    return SimpleNamespace(
        CryptoSystem=CryptoSystem, CLHSM2k=CLHSM2k, cgp=cuda_group, f2m=forms2,
        hostgmp=hostgmp, lb=limb, TorchEngine=TorchEngine, Tensor=Tensor,
        bform_from_forms=bform_from_forms, bform_to_forms=bform_to_forms)


def report_build(cgp) -> None:
    """Build time and ptxas's register and spill report of each kernel."""
    log(f"kernel build: {cgp.BUILD_INFO['seconds']:.1f} s for {list(cgp.KERNELS)}")
    lines = cgp.BUILD_INFO["log"].splitlines()
    spills = [ln.strip() for ln in lines if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines if "registers" in ln]
    if regs:
        log(f"ptxas: {len(regs)} kernel instances, registers {min(regs)}-"
            f"{max(regs)} a thread, {len(spills)} with spills"
            + "".join("\n  " + x for x in spills))
        for ln in lines:
            if ln.startswith("== ") or "registers" in ln or "Compiling entry" in ln:
                log("  " + ln.strip())
    else:
        log("ptxas: libraries were already built, no compiler report")


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    port = import_port()
    if port is None:
        return 1
    cgp, f2m, hostgmp, lb = port.cgp, port.f2m, port.hostgmp, port.lb
    bform_from_forms, bform_to_forms = port.bform_from_forms, port.bform_to_forms

    t_start = time.perf_counter()
    smi = card_line()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    if hostgmp.get_lib() is None:
        fail("the GMP host backend (g++ + libgmp) did not build")
    log("host backend: GMP (csrc/classgroup.cpp)")
    cgp.build()
    report_build(cgp)

    rng = random.Random(SEED)
    t = time.perf_counter()
    k1 = {}
    for W, nbits, need_u, op_bits in ((88, 1392, False, 1100),
                                      (144, 2117, False, 2085),
                                      (144, 2117, True, 2085),
                                      (8, 136, False, 120),
                                      (1, 16, True, 12)):
        for B in (KERNEL_B, RAGGED_B):
            k1[(W, need_u, B)] = check_k1(torch, cgp, lb, rng, W, nbits,
                                          need_u, B, op_bits)
    k2 = {B: check_k2(torch, cgp, lb, rng, B) for B in (KERNEL_B, RAGGED_B)}
    k2[SMALL_B] = check_k2(torch, cgp, lb, rng, SMALL_B, edge_cases=True)
    hsm = port.CLHSM2k(SEC, K)
    cg = port.TorchEngine(hsm, "cuda").cg
    gmp = hostgmp.GmpClassGroup(hsm.Delta)
    k3 = {B: check_k3(torch, cgp, cg, f2m, gmp, hsm, bform_from_forms,
                      bform_to_forms, rng, B) for B in (KERNEL_B, RAGGED_B, SMALL_B)}
    log(f"kernel checks: {time.perf_counter() - t:.1f} s")

    rec = Recorder(torch, cgp)
    launches, _ = run_slice(torch, cgp, rec, port.CryptoSystem, port.Tensor,
                            hostgmp.GmpEngine, rng)
    # K1 on the decrypt steps' d > 1 lanes, where cg is not unique mod m and
    # only the reference's divstep sequence gives the plain version's cg
    dec_lanes = decrypt_k1_lanes(lb, rec)
    if not dec_lanes:
        fail("no recorded decrypt K1 lane has d > 1")
    for W, nbits, pairs in dec_lanes:
        for need_u in (False, True):
            check_k1(torch, cgp, lb, rng, W, nbits, need_u, RAGGED_B,
                     nbits - 40, extra=pairs)

    t = time.perf_counter()
    table = []
    with torch.inference_mode():
        for key in sorted(rec.ops, key=lambda k: (k[3], k[0], k[1])):
            table.append(table_row(torch, cgp, f2m, cg, lb, key, rec.ops[key],
                                   rec.counts[key]))
    log(f"kernel table: {time.perf_counter() - t:.1f} s, {len(table)} rows")
    for want in TABLE_B:
        if not any(r["name"].endswith(f"@B={want}") for r in table):
            fail(f"no main-path operands were recorded at batch {want}")

    profile_compose(torch, cg, gmp, hsm, bform_from_forms, rng, "this tree's kernels")

    def entry(name, route_src, replaces, r):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    src = {"xgcd_coeff_g": ("cofhe_tpu_torch/csrc/xgcd_coeff_g.cu",
                            "cofhe_tpu/ops/pallas_group.py:144"),
           "mod_topdown": ("cofhe_tpu_torch/csrc/mod_topdown.cu",
                           "cofhe_tpu/ops/pallas_group.py:103"),
           "reduce2_grouped": ("cofhe_tpu_torch/csrc/reduce2_grouped.cu",
                               "cofhe_tpu/ops/forms2.py:233")}
    kernels = [
        entry("xgcd_coeff_g", *src["xgcd_coeff_g"], k1[(88, False, KERNEL_B)]),
        entry("mod_topdown", *src["mod_topdown"], k2[KERNEL_B]),
        entry("reduce2_grouped", *src["reduce2_grouped"], k3[KERNEL_B]),
    ]
    for r in table:
        base_name = r["name"].split("[")[0].split("@")[0]
        kernels.append({"route": "cuda", "source": src[base_name][0],
                        "replaces": src[base_name][1], **r})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
