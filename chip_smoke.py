#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (cofhe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py       # from the root of a checkout

1. Builds the thirteen Hopper kernels from cofhe_tpu_torch/csrc with nvcc
   (one nvcc a source, all started together) and holds each one against
   its plain torch version on the card, at the shapes the main path gives
   it and at 128, 1001 and 16384 lanes (bit-exact, and against Python
   integers and GMP), timing both; K2 also on the edge cases of its wide
   digit. K5m (products), K5d (exact quotients) and K4 (REDC into [0, d))
   at every shape of compose2, with edge cases at 128 lanes (zero and
   all-0xFFFF operands, y = 1, y of one limb padded to its width, quotients
   that fill L_out, d = 1, d of one limb, inactive lanes, x with its top
   limb set; divisors of different significant widths, and active and
   inactive K4 rows, in one block of four warps; K4 also with every lane
   inactive, as compose2's rare-lane REDCs run), K5m at widths 1 to 288
   with L_out below, at and above La + Lb, and K5d and K4 at widths and
   step counts that are not multiples of a thread's limbs (1, 31, 33, 143,
   K4 also with x wider than its steps). K5m is also timed at each of its
   launch shapes (1, 2 and 4 warps a row) at compose2's shapes and
   batches. The build's ptxas report gives the registers, stack frame and
   spills of each K5m, K5d, K4 and KT instance and which of them compose2
   launches; the SASS of every K5m instance (cuobjdump -sass) must hold
   IMMA instructions, its products on the tensor cores, and the counts of
   IMMA, warp collectives, shared atomics and barriers in each K5m and KT
   instance are printed. KT, the exact tail, runs on K3's
   outputs of real compose2 operands (self-composes, inverse pairs and
   powers of f, which drop deep into the tail), must give GMP's composes,
   and on edge cases (b = -a, a = c with b < 0, a > c, reduced forms, and
   forms of the discriminant translated by quotients of up to ~600 bits)
   the Python oracle's and GMP's reduced forms; no lane may reach its cap.
   K7, the NUCOMP tail's Lehmer walk, runs on the walk operands of real
   compose2 pairs (2m2, mu and the stop bits of a NUCOMP CG) at 128, 1001
   and 16384 lanes, and at 128 lanes on edge lanes at widths 16, 24, 32,
   40 and 144 (quotient gaps past 2^13, inactive lanes, lanes finished at
   entry, stopped by the y cap, cut at the group cap): its seven outputs
   and its groups a lane must equal its plain version's bit for bit. No
   K7 instance may spill (ptxas), and a build of K7 with -DK7_PHASES
   (tools/kernel_compare.PhaseLib, equal to K7 on the same operands)
   prints the split of a group's cycles by phase (estimates, simulation,
   digit step, apply, idle carry passes) at 128 and 16384 lanes. K6a,
   compose2's signed sums canonicalized, at widths 8, 72, 144 and 264 on
   128, 256 and 16384 lanes (two-term sums with the contract's edge rows
   first, three-term sums with multipliers 1, -1 and 2 and narrower terms,
   one redundant term with a top limb that carries; b >> 1 beside; two sums
   a launch), and K6b, compose2's prologue with the first gcd's operands,
   on compose2 operand pairs (identities on either side and both,
   self-composes, inverse pairs, powers of f) and on rows whose a's have
   nb - 1, nb and nb + 1 bits (nb = 16 Lxn - 32: both sides of the
   narrow pass) at the same batches; K6c, the bridge between compose2's
   gcds, with and without the narrow pass (d1 = 2^120 - 1 and 2^120 on
   narrow and wide lanes, identity lanes), K6d, the second gcd's merge,
   and K6e, c3's operands (e = v2(a3) = 0, 15, 16, 32, 16 L - 1 and a zero
   a3), at compose2's widths on the same batches: bit-exact against their
   plain versions, K6a, K6c, K6d and K6e against Python integers. No
   K6a-K6e instance may spill (ptxas).
2. Drives the main path once at sec=128, k=128 through the facade:
   keygen, encrypt_tensor ct(2x64), scal_ciphertext_tensors with pt(64x64)
   (16384 ladder lanes), decrypt_tensor; every plaintext must equal the
   integer matmul mod 2^128, every kernel's launch counter must have grown,
   and two output ciphertexts must be bit-identical to the GMP host
   backend's for the same inputs and Enc(0). Each compose2 on the card is
   a replay of the CG's CUDA graph for its batch (ops/graphs.py), captured
   at first use after one eager warm-up; the launch counters count each
   replay's captured kernels, by (kernel, width, extra, batch). Each
   graph's warm-up and capture seconds and its memory pool are printed.
   The main path's 128 ciphertexts are then decrypted once more by graph
   replays and once by an eager engine (`eager_cg`): the c1^sk forms and
   the plaintexts must be bit-identical, and the launch counts of all
   thirteen kernels equal; both wall times are printed. Operands are recorded from
   the eager calls (a replay calls no wrapper): one decrypt compose2 (128
   lanes) from the eager decrypt, one chain (256) and one ladder (16384)
   compose2 from the graphs' warm-ups. K1 is then checked again, with and
   without need_u, on the recorded decrypt lanes whose gcd is above 1
   (there cg is not unique mod m: only the reference's divstep sequence
   gives it).
3. Engine ops at sec=128, k=128 on 64 of the main path's ciphertexts:
   add_ciphertext_vectors and scal_ciphertext_vector (scalars 0, 1,
   2^k - 1 and random k-bit values, the Yao ladder) must give the GMP host
   engine's forms bit for bit, and the batched threshold combine
   (combine_batch, t = 2 of n = 3, part-decryptions from GMP) the
   plaintexts.
4. The threshold network at sec=128, k=128: 1 setup, 3 CoFHE and 1 compute
   node as in-process servers (t = 2, n = 3, no TLS); the setup node, the
   compute node, the client and CoFHE node 0 run on the card, CoFHE nodes 1
   and 2 on the GMP host. The client sends one 4x4 . 4x4 ciphertext
   MULTIPLY (a Beaver matmul: 64 products, one opening round of 128
   ciphertexts) and one tensor ADD; the dealer's key decrypts the results
   on the GMP host, which must equal the integer matmul and sum mod 2^128.
   CoFHE node 0 must have answered the opening round on the card (the
   compute node's share combination is (0, 1), and every kernel launched
   inside node 0's part-decryption).
5. The mesh at sec=128, k=128: two ranks of
   cofhe_tpu_torch.tools.mesh_check (torch.distributed; NCCL with a card
   each when there are two, else gloo with both on one card), a dp=1 x
   tp=2 mesh, a TorchEngine(mesh=...) on each. They run the main path's
   scal_matmul (each rank ladders its 32-column half at 8192 lanes and the
   2048-form banks meet in an all_gather), the engine-ops path's 64 adds
   row-sharded, and the t=2 threshold combine of 16 of the main path's
   ciphertexts over tp (part-decryptions from GMP). Both ranks must return
   the same ciphertexts, bit-identical to the single-card matmul and adds,
   the combine the plaintexts; each rank's K2 launches must show the
   ladder at 8192 lanes and none at 16384, and its gathers must be > 0.
6. The legacy path at sec=128, k=128 on 128 of the main path's
   ciphertexts (c1 and c2 forms), the opt-in and legacy code of the JAX
   package: NUCOMP compose2 and nudupl2 (CG(..., use_nucomp=True): K7
   walks, then the reduction runs K3 and KT at width Ln = 272), as graph
   replays and eagerly, must equal each other, the default compose2 /
   nudupl2 and GMP; nupow_shared_wnaf2 with a 128-bit exponent must equal
   the engine's bank + segments (part_decrypt_batch) and GMP's nupow; the
   v1 compose_batch / nudupl_batch (torch ops only, with ops/xgcd.py) must
   equal compose2 / nudupl2 and GMP, and one xgcd_mod batch math.gcd and
   the Bezout identity mod m. One compose2 on the same 128 forms is
   profiled four ways: the default tail and the NUCOMP tail, each eager
   and as a graph replay: wall and device time (the device's busy share),
   device time split by kernel (the thirteen, and "other": what is left in
   torch ops), device kernels and copies, and Lehmer groups a lane; for
   the eager ones "other" split by section of compose2 (the prologue, the
   first-gcd selects, the second-gcd selects, xi / u / mu_red, the a3 / b3
   / c3 epilogue, the reduction's operands or the NUCOMP tail, the
   identity selects; compose_sections). Then
   NUCOMP and default compose2, both by graph replay, on the same pairs
   of the main path's forms at 128, 256 and 16384 lanes in turns
   (default, NUCOMP, NUCOMP, default): equal outputs (and equal to GMP),
   the time a call on the card's clock.
   Each path (main, engine ops, network, mesh, legacy) is driven with the
   launch counts set to 0 just before it and read just after (on the mesh:
   each rank's, summed); every kernel must launch in each (K7, the NUCOMP
   tail's, in the legacy path, the one path that takes NUCOMP), and the counts
   by (kernel, batch) must equal those kept apart from them (each eager
   dispatcher call plus each graph replay's captured kernels,
   tools/mesh_check.count_calls), on each mesh rank too.
7. The kernel table: every kernel at every recorded main-path shape and
   batch, checked against its plain versions (K1 also against Python's
   gcd and the Bezout identity, KT against the Python oracle), with its
   trip counts (K1 in groups and in divsteps, KT in steps: its exact-tail
   iterations), time and bound (also at the earlier kernels' per-limb
   operation counts: the 13-divstep K1, the 24-bit-digit K2, the
   2^12-budget K3), K3 and KT at the legacy path's width 272, and K7 at
   the legacy path's NUCOMP operands. K5m,
   K5d and K4 also against Python integers, with the cuFFT route (their
   plain versions on the card) as each one's plain time; K6a at each of
   compose2's and the NUCOMP tail's calls, also against Python integers,
   K6b, K6c, K6d and K6e (K6e also against Python integers).
8. Prints the card's name and power limit, one JSON line with each
   kernel's numbers (launches in all and by path), and as the last line
   {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. It needs CUDA and
the rest of the repository; without either it exits non-zero and prints no
result. `python3 -m cofhe_tpu_torch.tools.kernel_compare` times an
earlier csrc/'s kernels beside this tree's on the same recorded operands.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import random
import re
import socket
import subprocess
import sys
import time

SEED = 20261016
SEC, K = 128, 128
N_ROWS, M_INNER, P_COLS = 2, 64, 64
KERNEL_B = 16384   # lanes of one matmul ladder chunk
RAGGED_B = 1001
SMALL_B = 128      # lanes of a decrypt step
ENGINE_N = 64      # ciphertexts of the engine-ops phase
MESH_RANKS = 2     # the mesh path: dp = 1 x tp = 2
MESH_COMBINE_N = 16  # ciphertexts of its threshold combine
MESH_LADDER_B = 2 * N_ROWS * (M_INNER // MESH_RANKS) * P_COLS  # 8192 a rank
MESH_TIMEOUT_S = 420  # a rank's whole run
NET_DIM = 4        # the network's ct(4x4) . ct(4x4) Beaver matmul
OPENING_B = 2 * NET_DIM ** 3  # ciphertexts of its opening round
# the triplet cache deals exactly the 64 triplets of the matmul; the node
# runtime's default 120 s RPC and client timeouts cover a part-decryption
# ladder on the card by graph replays (~16 s at sec=128, PERF.md)
NODE_ENV = {"COFHE_TRIPLET_CACHE": str(NET_DIM ** 3)}
TABLE_B = (128, 256, 16384)  # decrypt, chain, ladder compose2 batches
LEGACY_B = 128         # lanes of the legacy path
LEGACY_EXP_BITS = 128  # its shared wNAF exponent
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
# KT per step and limb, as a translation: two value estimates (8), two
# shifted 64-bit products with their 4-digit spreads and carry passes (56),
# the b' and aq - b sums (6), three canonicalizations (90: two floor
# passes, the carry-map code and its warp scan, the fix-up), three
# comparisons and the c update (10); a step that is only a rho costs a
# register swap, so the count is an upper one
OPS_KT = 170
OPS_K1_OLD, OPS_K2_OLD, OPS_K3_OLD = 108 / 13, 20, 74
# K7 per working group and limb: three ordered value estimates (12), the
# 2x2 matrix on six rows (two products and a sum an output limb, 18) and
# their six carry passes (30); a digit-step group costs ~75, an idle
# group 48 and is not counted (the bound counts the groups the data needs)
OPS_K7 = 60
# K7's edge lanes at 128 lanes: (width, bits of r0, group cap); the NUCOMP
# against default comparison's batches
K7_EDGE = ((16, 220, 60), (24, 330, 80), (32, 440, 100), (40, 600, 110),
           (144, 2100, 178))
NUCOMP_B = (128, 256, 16384)
# K7's device kernels (kernel A walks, kernel B finishes)
K7_DEVICE = ("lehmer_euclid_walk_kernel", "lehmer_euclid_finish_kernel")
# K5m, K5d and K4: a 16 x 16 -> 32-bit limb product with its 64-bit add
# counts 3 (the add as 2); a row's carry resolution 25 a limb (the 64-bit
# split 4, two floor passes 10, the carry ballots 4, the ripple and store
# 7); a digit step of K5d and K4 6 (the carry fold, the digit and its
# broadcast); K4's comparison with d and subtraction 40 a limb (with a
# canonicalization)
OPS_MAD, OPS_CARRY, OPS_STEP, OPS_K4_TAIL = 3, 25, 6, 40
# Their limb products are 8-bit-limb products, the work the JAX package
# ran on the TPU's matrix unit as an 8-bit convolution and the plain
# versions split into 8-bit limbs: their bound takes them at the card's
# dense int8 tensor-core rate (data sheet), four 8-bit multiply-adds (8
# ops) a 16 x 16-bit limb pair, beside the carries and digit steps at the
# int32 rate (other units: the larger of the two counts)
INT8_TC_OPS_PER_S = 1979e12
OPS_TC_PAIR = 8
# compose2's products (La, Lb, L_out), exact quotients (Lx, Ly, L_out) and
# REDCs (Lx, Ld; Lh steps) at sec=128, k=128: L=144, Lh=72, Lu=200,
# Lm=264, Lsq=136 (forms2.CG.compose2_unreduced)
K5M_SHAPES = ((72, 72, 144), (72, 144, 144), (72, 144, 200), (200, 72, 264),
              (136, 136, 264))
K5D_SHAPES = ((144, 144, 72), (144, 72, 144), (144, 72, 72), (264, 264, 144))
K4_SHAPES, K4_STEPS = ((72, 72), (8, 8)), 72
# K5d and K4 at widths and step counts that are not multiples of a thread's
# limbs (NPT = ceil(width / 32)): K5d (Lx, Ly, L_out) and K4 (Lx, Ld, steps),
# K4 also with Lx > steps
K5D_EDGE_SHAPES = ((1, 1, 1), (31, 31, 31), (33, 8, 33), (143, 143, 143), (288, 288, 288))
K4_EDGE_SHAPES = ((1, 1, 1), (31, 31, 31), (33, 8, 33), (143, 143, 143), (100, 8, 33))
# K5m's edge shapes: widths 1 to 288, L_out below, at and above La + Lb
K5M_EDGE_SHAPES = ((1, 1, 1), (1, 1, 2), (1, 1, 3), (8, 8, 8), (8, 8, 16),
                   (8, 8, 20), (72, 72, 72), (72, 72, 150), (144, 144, 144),
                   (144, 144, 288), (144, 8, 160), (200, 72, 272), (200, 200, 288),
                   (264, 264, 264), (264, 8, 272), (264, 24, 288), (288, 288, 288),
                   (288, 1, 288), (1, 288, 288), (288, 288, 1))
# K6a per output limb of a sum: its terms' products and adds (2 a term),
# two floor passes (10), the carry map and its share of the warp scan (8),
# the carry fix-up, negation select and sign (6), the shifted output (4);
# K6b: two such sums at Lh and, a limb of L, the identity sums and the
# compare (4). K6a's widths: compose2's (Lh and the NUCOMP cofactor
# products, L, Lm) and the smallest
OPS_K6A, OPS_K6A_TERM, OPS_K6B_L = 28, 2, 4
K6A_W = (8, 72, 144, 264)
# K6b's first-gcd operands, K6c and K6d: a select and its store an output
# limb; K6e an output limb: its two staged limbs, the two shifts, the mask
# and the or (and one a staged limb)
OPS_K6_SEL, OPS_K6E = 2, 6
# compose2's sections, by the comment that opens each in
# forms2.CG.compose2_unreduced (the prologue runs from its start)
SECTION_MARKS = (("first-gcd selects", "# first gcd"),
                 ("second-gcd selects", "# second gcd"),
                 ("xi / u / mu_red", "# xi = "),
                 ("a3 / b3 / c3 epilogue", "# a3 = "))
# KT's width at sec=128, k=128 (L), and K5m's launch shapes timed beside
# the launcher's choice: warps a row
KT_L = 144
K5M_WPR = (1, 2, 4)
# SASS mnemonics counted in the K5m and KT instances (check_sass)
SASS_OPS = ("IMMA", "SHFL", "VOTE", "REDUX", "ATOMS", "BAR")
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
        a3, b3s, b3m, c3, *_ = cg.compose2_unreduced(b1, b2)
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


def kt_edge_forms(base, rng, L, n):
    """n positive definite edge-case forms for KT, with each one's reduced
    form from the Python oracle: b = -a, a = c with b < 0, normal with
    a > c, reduced forms of the discriminant (GMP's), and those forms
    translated by quotients of up to ~600 bits and rotated (a rho),
    whose reduced form is GMP's form again."""
    from cofhe_tpu_torch.core.qfi import Form, reduce_form

    forms, want = [], []
    for i in range(n):
        kind = i % 6
        a = rng.getrandbits(rng.randrange(20, 1000)) | 1
        if kind == 0:
            f = Form(a, -a, a + rng.getrandbits(900))
        elif kind == 1:
            f = Form(a, -rng.randrange(1, a), a)
        elif kind == 2:
            c = rng.randrange(a // 2 + 1, a)
            f = Form(a, rng.randrange(-c + 1, c), c)
        else:
            g = base[rng.randrange(len(base))]
            f = g
            if kind >= 4:  # c' ~ a t^2 keeps 64 bits of room in L limbs
                t_bits = (16 * L - 64 - g.a.bit_length()) // 2
                t = rng.getrandbits(rng.randrange(1, t_bits)) * rng.choice((1, -1))
                f = Form(g.a, g.b + 2 * g.a * t, g.c + g.b * t + g.a * t * t)
            if kind == 5:
                f = Form(f.c, -f.b, f.a)
            forms.append(f)
            want.append(g)
            continue
        forms.append(f)
        want.append(reduce_form(f))
    if [reduce_form(f) for f in forms] != want:
        fail("the KT edge cases' oracle disagrees with GMP's reduced forms")
    return forms, want


def kt_operands(cgp, cg, hsm, port, rng, base, B, deep=True):
    """KT's operands from B compose2 operand pairs drawn from the forms
    `base`: K3's redundant outputs (a, b, c) and the pairs. With `deep`,
    every sixth lane of the first 96 is a self-compose, then an inverse
    pair and two powers of f, which drop deep into the exact tail."""
    from cofhe_tpu_torch.core.qfi import neg, reduce_form

    f1 = [base[rng.randrange(len(base))] for _ in range(B)]
    f2 = [base[rng.randrange(len(base))] for _ in range(B)]
    for i in range(0, min(B, 96) if deep else 0, 6):
        f1[i] = f2[i]                                  # a self-compose
        f1[i + 1] = reduce_form(neg(f2[i + 1]))        # an inverse pair
        f1[i + 2] = hsm.power_of_f(rng.getrandbits(K))
        f2[i + 3] = hsm.power_of_f(rng.getrandbits(K))
    b1 = port.bform_from_forms(f1, cg.L, "cuda")
    b2 = port.bform_from_forms(f2, cg.L, "cuda")
    a3, b3s, b3m, c3, *_ = cg.compose2_unreduced(b1, b2)
    raw = cgp.reduce2_grouped_loop_cuda(a3, b3s[..., None] * b3m, c3, cg.dD_mant,
                                        cg.dD_top, cg.red_iters)
    return f1, f2, raw


def check_kt(torch, cgp, cg, gmp, hsm, port, rng, B):
    """KT on K3's outputs of B compose2 operand pairs (random powers of h,
    self-composes, inverse pairs, powers of f) and, at 128 lanes, on edge
    cases: bit-exact against its plain version, GMP's composes and the
    Python oracle, every lane reduced before the cap."""
    from cofhe_tpu_torch.core.qfi import is_reduced

    base = gmp.nupow_batch([hsm.h] * 64, [rng.getrandbits(1100) for _ in range(64)])
    cap = cg.tail_iters
    with torch.inference_mode():
        f1, f2, raw = kt_operands(cgp, cg, hsm, port, rng, base, B)
        cases = [("compose", raw, gmp.compose_batch(f1[:256], f2[:256]))]
        if B == SMALL_B:
            forms, want = kt_edge_forms(base, rng, cg.L, B)
            e = port.bform_from_forms(forms, cg.L, "cuda")
            cases.append(("edge cases", (e.a, e.b_sign[:, None] * e.b, e.c), want))
        for label, (a, b, c), want in cases:
            iters = torch.zeros(B, dtype=torch.int32, device="cuda")
            got = cgp.reduce_exact_cuda(a, b, c, cap, iters=iters)
            err = max_abs_diff(torch, got, cgp.reduce_exact_plain(a, b, c, cap))
            if err:
                fail(f"KT B={B} ({label}) differs from its plain version (max {err})")
            out = port.bform_to_forms(got)
            if out[:len(want)] != want or not all(is_reduced(f) for f in out):
                fail(f"KT B={B} ({label}): reduced forms differ from GMP's / the oracle's")
            if int(iters.max()) > cap:
                fail(f"KT B={B} ({label}): a lane reached the cap of {cap} steps")
            log(f"KT reduce_exact L={cg.L} B={B} ({label}): bit-exact vs plain, equal "
                f"to {'GMP' if label == 'compose' else 'the oracle and GMP'}, steps "
                f"{_stats(iters)} (cap {cap})")
            if label == "compose":
                kt_iters = iters
        ms = timed(torch, lambda: cgp.reduce_exact_cuda(*raw, cap), TIMING_REPS)
        plain_ms = timed(torch, lambda: cgp.reduce_exact_plain(*raw, cap), 1,
                         warm=False) if B == KERNEL_B else float("nan")
    ops = float(kt_iters.long().sum()) * cg.L * OPS_KT
    bms, by = bound(ops, 4.0 * B * (6 * cg.L + 2))
    log(f"KT reduce_exact L={cg.L} B={B}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


def k7_edge_operands(torch, lb, rng, B, L, bits):
    """(r0, r1, bits_stop, active) of B lanes at width L on the card: the
    kinds of lane of tests/test_torch_lehmer_kernel.py (r0 = q r1 + small
    with q > 2^13, r1 far below r0, finished at entry, r1 = r0, r1 = 1,
    stopped by the y cap, never stopping above bits_stop so cut at the
    group cap, inactive, finished at entry with rows that change under
    every carry pass), the rest random."""
    r0 = [rng.getrandbits(rng.randrange(bits // 2, bits)) | 1 for _ in range(B)]
    r1 = [rng.randrange(1, x) for x in r0]
    stop = [rng.choice((20.0, bits / 4, bits / 3 + 0.5)) for _ in range(B)]
    for i in range(6):
        r1[i] = rng.getrandbits(bits // 3) + 1
        q = rng.getrandbits(rng.randrange(14, bits // 3)) | (1 << 14)
        r0[i] = q * r1[i] + rng.randrange(r1[i])
        stop[i] = 10.0
    for i in (6, 7):
        r1[i] = rng.getrandbits(rng.randrange(24, bits // 3)) + 1
        stop[i] = 10.0
    stop[8] = float(bits)
    r1[9], r1[10] = r0[9], 1
    r0[11], stop[11] = 1, 30.0
    r0[12], r1[12], stop[12] = 0, r1[13], 5.0
    stop[14] = stop[15] = -300.0
    active = torch.ones(B, dtype=torch.bool)
    active[16] = active[17] = False
    for i, k in ((18, L - 2), (19, 3)):  # finished at entry, limbs 0x8000, 0x7fff,
        # ...: each idle group's carry pass moves a carry one limb up
        r0[i] = r1[i] = sum(0x7FFF << (16 * j) for j in range(1, k + 1)) + 0x8000
        stop[i] = 16.0 * (k + 1) + 1.0
    return (_limbs(torch, lb, r0, L), _limbs(torch, lb, r1, L),
            torch.tensor(stop, dtype=torch.float32, device="cuda"), active.cuda())


def k7_bound(iters, B, L):
    """K7's bound: the working groups' operations at OPS_K7 a limb, and
    r0, r1 in, the six rows out (with bits_stop, par and iters)."""
    return bound(float(iters.long().sum()) * L * OPS_K7, 4.0 * B * (8 * L + 3))


def k7_compare(torch, cgp, label, r0, r1, stop, max_groups, active=None):
    """K7 against its plain version on the card: the seven outputs and the
    groups a lane bit for bit. Returns K7's groups a lane."""
    B = r0.shape[0]
    it_k = torch.zeros(B, dtype=torch.int32, device="cuda")
    it_p = torch.zeros(B, dtype=torch.int32, device="cuda")
    got = cgp.lehmer_euclid_cuda(r0, r1, stop, max_groups, active=active, iters=it_k)
    want = cgp.lehmer_euclid_plain(r0, r1, stop, max_groups, active=active, iters=it_p)
    err = max_abs_diff(torch, got, want)
    if err or not torch.equal(it_k, it_p):
        fail(f"K7 {label}: differs from its plain version (max {err}, groups "
             f"equal: {torch.equal(it_k, it_p)})")
    return it_k


def k7_walk_operands(torch, ncg, gmp, hsm, bform_from_forms, rng, B):
    """(r0, r1, bits_stop) of the Lehmer walk of B compose2 pairs of powers
    of h under a NUCOMP CG (compose2_unreduced, then lehmer_operands: what
    its tail passes to K7)."""
    base = gmp.nupow_batch([hsm.h] * 64, [rng.getrandbits(1100) for _ in range(64)])
    f1 = [base[rng.randrange(64)] for _ in range(B)]
    f2 = [base[rng.randrange(64)] for _ in range(B)]
    b1 = bform_from_forms(f1, ncg.L, "cuda")
    b2 = bform_from_forms(f2, ncg.L, "cuda")
    with torch.inference_mode():
        _, _, _, _, a1g, m2x2, mu, _, _ = ncg.compose2_unreduced(b1, b2)
        r0, r1, stop = ncg.lehmer_operands(a1g, m2x2, mu)
    return r0.contiguous(), r1.contiguous(), stop


def check_k7(torch, cgp, ncg, lb, gmp, hsm, bform_from_forms, rng, B, clock=None):
    """K7 on the Lehmer walk operands of B compose2 pairs of a NUCOMP CG
    (k7_walk_operands) and, at 128 lanes, on K7_EDGE's edge lanes:
    bit-exact against its plain version, with its time and bound; with
    `clock` (kernel_compare.PhaseLib, K7 built with -DK7_PHASES) also the
    split of a group's cycles by phase, at 128 and 16384 lanes."""
    r0, r1, stop = k7_walk_operands(torch, ncg, gmp, hsm, bform_from_forms, rng, B)
    mg = ncg.eu_groups
    with torch.inference_mode():
        iters = k7_compare(torch, cgp, f"B={B}", r0, r1, stop, mg)
        if clock is not None and B != RAGGED_B:
            clock.split(torch, sys.modules[__name__], f"lehmer_euclid[W={ncg.L},"
                        f"compose2 walk]@B={B}", r0, r1, stop, mg)
        if B == SMALL_B:
            for L, bits, cap in K7_EDGE:
                e0, e1, e_stop, e_act = k7_edge_operands(torch, lb, rng, B, L, bits)
                e_it = k7_compare(torch, cgp, f"edge lanes L={L}", e0, e1, e_stop, cap,
                                  active=e_act)
                if int(e_it[14]) != cap or int(e_it[16]) != 0:
                    fail(f"K7 edge lanes L={L}: the lane cut at the cap took "
                         f"{int(e_it[14])} groups, the inactive one {int(e_it[16])}")
            log(f"K7 lehmer_euclid edge lanes at widths {[e[0] for e in K7_EDGE]}, "
                f"B={B}: bit-exact vs plain (outputs and groups a lane)")
        ms = timed(torch, lambda: cgp.lehmer_euclid_cuda(r0, r1, stop, mg), TIMING_REPS)
        plain_ms = timed(torch, lambda: cgp.lehmer_euclid_plain(r0, r1, stop, mg), 1,
                         warm=False) if B != RAGGED_B else float("nan")
    bms, by = k7_bound(iters, B, ncg.L)
    log(f"K7 lehmer_euclid L={ncg.L} B={B} (compose2 walk operands): bit-exact vs "
        f"plain, groups {_stats(iters)} (cap {mg}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bms:.5f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


def _limbs(torch, lb, vals, L):
    return torch.as_tensor(lb.ints_to_limbs(vals, L)).to("cuda")


def k5m_pairs(La: int, Lb: int, Lo: int) -> int:
    """Limb products a row of a product mod 2^(16 Lo): pairs (i, j) with
    i < min(La, Lo), j < min(Lb, Lo) and i + j < Lo."""
    na, nb = min(La, Lo), min(Lb, Lo)
    return sum(max(0, min(c, na - 1) - max(0, c - nb + 1) + 1) for c in range(Lo))


def limb_bound(B, pairs, other, nbytes):
    """(ms, by, CUDA-core ms): the bound of K5m, K5d or K4 on B rows of
    `pairs` limb products and `other` int32 operations each, with the
    products at the int8 tensor-core rate; and, as a second figure, with
    the products on CUDA cores too (OPS_MAD each), as these kernels do them."""
    t_ops = max(B * pairs * OPS_TC_PAIR / INT8_TC_OPS_PER_S, B * other / INT32_OPS_PER_S)
    t_mem = nbytes / MEM_BYTES_PER_S
    cuda_cores_ms = bound(B * (pairs * OPS_MAD + other), nbytes)[0]
    return (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes",
            cuda_cores_ms)


def k5m_bound(B, La, Lb, Lo):
    return limb_bound(B, k5m_pairs(La, Lb, Lo), Lo * OPS_CARRY,
                      4.0 * B * (min(La, Lo) + min(Lb, Lo) + Lo))


def k5d_bound(B, Ly, Lo):
    ny = min(Ly, Lo)
    return limb_bound(B, sum(min(ny, Lo - k) for k in range(Lo)), Lo * OPS_STEP,
                      4.0 * B * (Lo + ny + Lo))


def k4_bound(B, Lx, Ld, steps):
    N = max(Lx, steps + Ld) + 1
    return limb_bound(B, steps * Ld, steps * OPS_STEP + N * (OPS_CARRY + OPS_K4_TAIL),
                      4.0 * B * (2 * Lx + Ld) + B)


def k5m_want(lb, a, b, Lo):
    mod = 1 << (16 * Lo)
    return [x * y % mod for x, y in zip(lb.limbs_to_ints(a.cpu()), lb.limbs_to_ints(b.cpu()))]


def k5d_want(lb, x, y, Lo, label):
    mod = 1 << (16 * Lo)
    out = []
    for i, (u, v) in enumerate(zip(lb.limbs_to_ints(x.cpu()), lb.limbs_to_ints(y.cpu()))):
        if v % 2 == 0:
            fail(f"{label} lane {i}: an even divisor")
        out.append(u * pow(v, -1, mod) % mod)
    return out


def k4_want(lb, x, d, steps, active, label):
    """R = (x + Q d) / 2^(16 steps) cut to x's width Lx, Q = -x d^-1 mod
    2^(16 steps) on active lanes and 0 on the others, less d once if R >=
    d: x 2^(-16 steps) mod d on active lanes when Lx <= steps (checked),
    floor(x / 2^(16 steps)) reduced once by d on the others."""
    act = [True] * x.shape[0] if active is None else active.cpu().tolist()
    Lx, mod = x.shape[1], 1 << (16 * steps)
    out = []
    for i, (u, v, a) in enumerate(zip(lb.limbs_to_ints(x.cpu()), lb.limbs_to_ints(d.cpu()),
                                      act)):
        if a and v % 2 == 0:
            fail(f"{label} lane {i}: an even modulus on an active lane")
        q = -u * pow(v, -1, mod) % mod if a else 0
        r = ((u + q * v) >> (16 * steps)) % (1 << (16 * Lx))
        out.append(r - v if r >= v else r)
        if a and Lx <= steps and out[-1] != u * pow(2, -16 * steps, v) % v:
            fail(f"{label} lane {i}: R - d is not x 2^(-16 steps) mod d")
    return out


def k5m_operands(rng, B, La, Lb, edge: bool):
    """Random canonical a (La limbs) and b (Lb limbs); with edge the first
    lanes hold zero operands, all-0xFFFF limbs, 1 and the top limb alone."""
    av = [rng.getrandbits(rng.randrange(1, 16 * La + 1)) for _ in range(B)]
    bv = [rng.getrandbits(rng.randrange(1, 16 * Lb + 1)) for _ in range(B)]
    if edge:
        fa, fb = (1 << 16 * La) - 1, (1 << 16 * Lb) - 1
        cases = [(0, bv[0]), (av[1], 0), (0, 0), (fa, fb), (fa, bv[4]), (av[5], fb),
                 (1, fb), (fa, 1), (1 << 16 * (La - 1), 1 << 16 * (Lb - 1)),
                 (fa, 1 << 16 * (Lb - 1))]
        for i, (x, y) in enumerate(cases[:B]):
            av[i], bv[i] = x, y
    return av, bv


def check_k5m(torch, cgp, lb, rng, B, La, Lb, Lo, edge=False, timing=True):
    """K5m at (La, Lb) -> L_out on B synthetic lanes: bit-exact against its
    plain version (the cuFFT route) and a * b mod 2^(16 L_out)."""
    av, bv = k5m_operands(rng, B, La, Lb, edge)
    a, b = _limbs(torch, lb, av, La), _limbs(torch, lb, bv, Lb)
    got = cgp.mag_mul_cuda(a, b, Lo)
    torch.cuda.synchronize()
    label = f"K5m La={La} Lb={Lb} L_out={Lo} B={B}"
    err = max_abs_diff(torch, [got], [cgp.mag_mul_plain(a, b, Lo)])
    if err:
        fail(f"{label} differs from its plain version (max {err})")
    if lb.limbs_to_ints(got.cpu()) != k5m_want(lb, a, b, Lo):
        fail(f"{label} differs from a * b mod 2^(16 L_out)")
    if not timing:
        return None
    ms = timed(torch, lambda: cgp.mag_mul_cuda(a, b, Lo), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.mag_mul_plain(a, b, Lo), 1,
                     warm=False) if B == KERNEL_B else float("nan")
    bms, by, bcc = k5m_bound(B, La, Lb, Lo)
    by_wpr = k5m_launch_shapes(torch, cgp, a, b, Lo, got)
    log(f"{label}: bit-exact vs plain and a * b mod 2^(16 L_out); kernel {ms:.4f} ms, "
        f"plain (cuFFT) {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}), on CUDA cores "
        f"{bcc:.5f} ms; K5m launch shapes, warps a row "
        + " / ".join(f"{w}: {t:.4f}" for w, t in by_wpr.items()) + " ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_cuda_cores_ms=bcc, err=err)


def k5m_launch_shapes(torch, cgp, a, b, Lo, want):
    """K5m through mag_mul_launch_split at each launch shape (warps a row,
    K5M_WPR) on the same operands: bit-exact against `want`; {warps: ms}."""
    import ctypes

    fn = ctypes.CDLL(cgp._lib_path("mag_mul")).mag_mul_launch_split
    fn.restype = ctypes.c_int
    fn.argtypes = cgp._ARGTYPES["mag_mul"][:-1] + [ctypes.c_int, ctypes.c_void_p]
    B, out = a.shape[0], {}
    res = torch.empty_like(want)
    for wpr in K5M_WPR:
        def call(wpr=wpr):
            rc = fn(a.data_ptr(), b.data_ptr(), res.data_ptr(), B, a.shape[1], b.shape[1],
                    a.stride(0), b.stride(0), Lo, wpr, torch.cuda.current_stream().cuda_stream)
            if rc:
                fail(f"K5m at {wpr} warps a row: launch failed, cudaError {rc}")
        res.zero_()
        call()
        if not torch.equal(res, want):
            fail(f"K5m at {wpr} warps a row differs from the launcher's product")
        out[wpr] = timed(torch, call, TIMING_REPS)
    return out


def k5d_operands(rng, B, Lx, Ly, Lo, edge: bool):
    """Odd y (Ly limbs) and x (Lx limbs): exact multiples q y on odd lanes,
    any x on even ones (the contract is x y^-1 mod 2^(16 L_out)); with
    edge the first lanes hold y = 1, y of one limb padded to Ly, all-0xFFFF
    y and a y of half the width in one block of four rows (one warp each),
    x = 0, all-0xFFFF x, and quotients that fill L_out."""
    xs, ys = [], []
    for i in range(B):
        y = rng.getrandbits(rng.randrange(1, 16 * Ly + 1)) | 1
        if i % 2:
            room = min(16 * Lx - y.bit_length(), 16 * Lo)
            x = rng.getrandbits(rng.randrange(0, room + 1)) * y
        else:
            x = rng.getrandbits(rng.randrange(1, 16 * Lx + 1))
        xs.append(x)
        ys.append(y)
    if edge:
        full_q, full_x = (1 << 16 * Lo) - 1, (1 << 16 * Lx) - 1
        small = rng.getrandbits(15) | (1 << 15) | 1
        half = ys[3] % (1 << 8 * Ly) | (1 << (8 * Ly - 1)) | 1
        cases = [(xs[0], 1), (full_x, small), (xs[2], (1 << 16 * Ly) - 1), (xs[3], half),
                 (0, ys[4]), (0, 1), (full_q, 1), (full_q * small % (full_x + 1), small),
                 (xs[8] * small % (full_x + 1), small), (xs[9], 3),
                 (full_x, (1 << 16 * Ly) - 1), (full_x, (1 << 16 * (Ly - 1)) | 1)]
        for i, (x, y) in enumerate(cases[:B]):
            xs[i], ys[i] = x, y
    return xs, ys


def check_k5d(torch, cgp, lb, rng, B, Lx, Ly, Lo, edge=False, timing=True):
    """K5d at (Lx, Ly) -> L_out on B synthetic lanes: bit-exact against its
    plain version and x y^-1 mod 2^(16 L_out) (the exact quotient on the
    lanes where y | x)."""
    xs, ys = k5d_operands(rng, B, Lx, Ly, Lo, edge)
    x, y = _limbs(torch, lb, xs, Lx), _limbs(torch, lb, ys, Ly)
    got = cgp.mag_divexact_odd_cuda(x, y, Lo)
    torch.cuda.synchronize()
    label = f"K5d Lx={Lx} Ly={Ly} L_out={Lo} B={B}{' with edge cases' if edge else ''}"
    err = max_abs_diff(torch, [got], [cgp.mag_divexact_odd_plain(x, y, Lo)])
    if err:
        fail(f"{label} differs from its plain version (max {err})")
    vals = lb.limbs_to_ints(got.cpu())
    if vals != k5d_want(lb, x, y, Lo, label) or any(
            v != (u // w) % (1 << 16 * Lo) for v, u, w in zip(vals, xs, ys) if u % w == 0):
        fail(f"{label}: not x y^-1 mod 2^(16 L_out) or not the exact quotient")
    if not timing:
        return None
    ms = timed(torch, lambda: cgp.mag_divexact_odd_cuda(x, y, Lo), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.mag_divexact_odd_plain(x, y, Lo), 1,
                     warm=False) if B == KERNEL_B else float("nan")
    bms, by, bcc = k5d_bound(B, Ly, Lo)
    log(f"{label}: bit-exact vs plain, x y^-1 mod 2^(16 L_out) and the exact quotients; "
        f"{Lo} digit steps; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bms:.5f} ms ({by}), on CUDA cores {bcc:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_cuda_cores_ms=bcc, err=err)


def k4_operands(rng, B, Lx, Ld, edge: bool):
    """Canonical x (Lx limbs), odd d (Ld limbs) and the active mask: 3 in 4
    lanes active; an inactive lane has d = 1 (as compose2's masks leave
    it) or a random odd d. With edge the first lanes hold d = 1, d of one
    limb padded to Ld, all-0xFFFF d, all-0xFFFF x, x with its top limb set,
    x = 0, x = d - 1, x = d, with active and inactive lanes and divisors of
    different widths in each block of four rows (one warp each)."""
    xs, ds, act = [], [], []
    for i in range(B):
        a = rng.random() < 0.75
        ds.append(rng.getrandbits(rng.randrange(1, 16 * Ld + 1)) | 1 if a or i % 2 else 1)
        xs.append(rng.getrandbits(rng.randrange(1, 16 * Lx + 1)))
        act.append(a)
    if edge:
        top = (0xFFFF << 16 * (Lx - 1)) | rng.getrandbits(16 * (Lx - 1))
        one = rng.getrandbits(15) | (1 << 15) | 1
        dmax = (1 << 16 * Ld) - 1
        xmax = (1 << 16 * Lx) - 1
        cases = [(xs[0], 1, True), (top, ds[1] | 1, False), (xs[2], dmax, True), (top, one, False),
                 (xs[4], one, True), (top, ds[5] | 1, True), (xs[6], 1, False),
                 (0, ds[7] | 1, True), ((ds[8] | 1) - 1, ds[8] | 1, True),
                 (min(ds[9] | 1, xmax), ds[9] | 1, True), (top, dmax, True), (top, 1, False),
                 (xmax, dmax, True), (xmax, one, False), (xmax, 1, True), (0, one, False)]
        for i, (x, d, a) in enumerate(cases[:B]):
            xs[i], ds[i], act[i] = x, d, a
    return xs, ds, act


def check_k4(torch, cgp, lb, rng, B, Lx, Ld, steps=K4_STEPS, edge=False, timing=True,
             masked=False):
    """K4 at (Lx, Ld) with `steps` on B synthetic lanes: bit-exact against
    its plain version and x 2^(-16 steps) mod d (floor(x / 2^(16 steps))
    reduced once by d on inactive lanes; k4_want for Lx > steps). With
    `masked` every lane is inactive, as compose2's `rare` REDCs leave
    almost every lane."""
    xs, ds, act = k4_operands(rng, B, Lx, Ld, edge)
    if masked:
        act = [False] * B
    x, d = _limbs(torch, lb, xs, Lx), _limbs(torch, lb, ds, Ld)
    active = torch.tensor(act, dtype=torch.bool, device="cuda")
    got = cgp.redc_mod_cuda(x, d, steps, active)
    torch.cuda.synchronize()
    label = (f"K4 Lx={Lx} Ld={Ld} steps={steps} B={B}{' with edge cases' if edge else ''}"
             f"{', every lane masked' if masked else ''}")
    err = max_abs_diff(torch, [got], [cgp.redc_mod_plain(x, d, steps, active)])
    if err:
        fail(f"{label} differs from its plain version (max {err})")
    if lb.limbs_to_ints(got.cpu()) != k4_want(lb, x, d, steps, active, label):
        fail(f"{label} differs from (x + Q d) / 2^(16 steps) less d once on Python integers")
    if not timing:
        return None
    ms = timed(torch, lambda: cgp.redc_mod_cuda(x, d, steps, active), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.redc_mod_plain(x, d, steps, active), 1,
                     warm=False) if B == KERNEL_B else float("nan")
    bms, by, bcc = k4_bound(B, Lx, Ld, steps)
    log(f"{label}: bit-exact vs plain and Python integers ({sum(act)} active lanes); "
        f"{steps} steps; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.5f} ms "
        f"({by}), on CUDA cores {bcc:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_cuda_cores_ms=bcc, err=err)


def check_limb_kernels(torch, cgp, lb, rng):
    """K5m, K5d and K4 at compose2's shapes on 16384, 1001 and 128
    synthetic lanes (edge cases at 128), and each at its edge shapes.
    Returns {kernel: {(shape, B): numbers}}. The checks added after the
    first ones draw from their own generator, so that `rng` reaches the
    later phases as it did before them (the same forms in a tree and its
    parent)."""
    out = {"mag_mul": {}, "divexact_odd": {}, "redc_mod": {}}
    own = random.Random(SEED + 9)
    for B in (KERNEL_B, RAGGED_B, SMALL_B):
        edge = B == SMALL_B
        for sh in K5M_SHAPES:
            out["mag_mul"][(sh, B)] = check_k5m(torch, cgp, lb, rng, B, *sh, edge=edge)
        for sh in K5D_SHAPES:
            out["divexact_odd"][(sh, B)] = check_k5d(torch, cgp, lb, rng, B, *sh, edge=edge)
        for sh in K4_SHAPES:
            out["redc_mod"][(sh, B)] = check_k4(torch, cgp, lb, rng, B, *sh, edge=edge)
            out["redc_mod"][(sh + ("masked",), B)] = check_k4(torch, cgp, lb, own, B, *sh,
                                                              edge=edge, masked=True)
    for sh in K5M_EDGE_SHAPES:
        check_k5m(torch, cgp, lb, rng, SMALL_B, *sh, edge=True, timing=False)
    log(f"K5m edge shapes (La, Lb, L_out) {list(K5M_EDGE_SHAPES)} at {SMALL_B} lanes: "
        f"bit-exact vs plain and a * b mod 2^(16 L_out) (zero operands, all-0xFFFF "
        f"limbs, 1, top limbs alone)")
    for sh in K5D_EDGE_SHAPES:
        check_k5d(torch, cgp, lb, own, SMALL_B, *sh, edge=True, timing=False)
    for Lx, Ld, steps in K4_EDGE_SHAPES:
        check_k4(torch, cgp, lb, own, SMALL_B, Lx, Ld, steps, edge=True, timing=False)
    log(f"K5d edge shapes (Lx, Ly, L_out) {list(K5D_EDGE_SHAPES)} and K4 edge shapes "
        f"(Lx, Ld, steps) {list(K4_EDGE_SHAPES)} at {SMALL_B} lanes, with edge cases: "
        f"bit-exact vs plain and Python integers")
    return out


# --------------------------------------- K6a and K6b: compose2's glue


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def k6a_cases(torch, lb, own, W, B):
    """K6a's sums at width W on B lanes, as (label, terms, values of the
    first 256 lanes): two terms, the edge rows first (a carry across every
    thread, a sum of exactly 0, zero terms, a negative result, a borrow
    through every limb, all-0xFFFF limbs, full rows: 9 limbs a thread at
    264); three terms with multipliers 1, -1 and 2, one of W / 2 limbs and
    one of 1; one term of redundant limbs in +-2^20 with the top limb that
    carries (2^16 over a borrow from below, and its negative)."""
    n = min(B, 256)
    base, top = 1 << (16 * W), 1 << (16 * (W - 1))
    edge = [(top - 1, 1, 1, 1), (top - 1, 1, top - 1, -1), (0, 0, 0, 1),
            (1, 1, 4 * top, -1), (top, 1, 1, -1), (base - 1, 1, 0, 0),
            (base - 2, -1, 1, -1), (base // 3, 1, base // 3, 1), (5, -1, 0, 1)]
    rows = edge + [(own.getrandbits(16 * W - 2), own.choice((-1, 0, 1)),
                    own.getrandbits(16 * W - 2), own.choice((-1, 0, 1)))
                   for _ in range(B - len(edge))]

    def term(vals, signs, L, k):
        mag = torch.from_numpy(lb.ints_to_limbs(vals, L)).cuda()
        return (mag, torch.tensor(signs, dtype=torch.int32, device="cuda"), k)

    two = [term([r[0] for r in rows], [r[1] for r in rows], W, 1),
           term([r[2] for r in rows], [r[3] for r in rows], W, 1)]
    cases = [("two terms", two, [r[0] * r[1] + r[2] * r[3] for r in rows[:n]])]
    spec = [(W, 1), (max(1, W // 2), -1), (1, 2)]
    vals = [[own.getrandbits(16 * L - 3) for _ in range(B)] for L, _ in spec]
    signs = [[own.choice((-1, 0, 1)) for _ in range(B)] for _ in spec]
    three = [term(v, sg, L, k) for v, sg, (L, k) in zip(vals, signs, spec)]
    cases.append(("three terms", three, [sum(k * sg[i] * v[i] for v, sg, (_, k) in
                                             zip(vals, signs, spec)) for i in range(n)]))
    red = [[own.randrange(-(1 << 20), 1 << 20) for _ in range(W - 1)]
           + [own.randrange(-8, 8)] for _ in range(B - 2)]
    carry = [-1] + [0] * (W - 2) + [0x10000]
    red = [carry, [-v for v in carry]] + red
    x = torch.tensor(red, dtype=torch.int32, device="cuda")
    cases.append(("one redundant term", [(x, None, 1)],
                  [sum(v << (16 * i) for i, v in enumerate(r)) for r in red[:n]]))
    return cases


def k6a_bound(B, W, rows, W_shr=None):
    """K6a's bound: each term read once (a one-row term once), its signs,
    the outputs written once; OPS_K6A an output limb of each sum plus
    OPS_K6A_TERM a term limb."""
    nbytes = ops = 0.0
    for ts in rows:
        for mag, sign, _ in ts:
            L = min(mag.shape[-1], W)
            nbytes += 4.0 * mag.shape[0] * L + (4.0 * B if sign is not None else 0.0)
            ops += OPS_K6A_TERM * B * L
        nbytes += 4.0 * B * (1 + W + (W_shr or 0))
        ops += OPS_K6A * B * W
    return bound(ops, nbytes)


def k6b_bound(B, L, Lh, Lxn=None):
    """K6b's bound: F1 and F2 read once, the six form rows, four signs, two
    Lh rows and two masks written once, and with Lxn < L the first gcd's
    mask and four operand rows; two K6a sums at Lh, the a rows' sums and
    compare, and OPS_K6_SEL an operand limb."""
    nbytes = 4.0 * B * 2 * (3 * L + 1) + 4.0 * B * (6 * L + 4 + 2 * Lh) + 2.0 * B
    ops = B * (2 * OPS_K6A * Lh + OPS_K6B_L * L)
    if Lxn is not None and Lxn < L:
        nbytes += 4.0 * B * (2 * Lxn + 2 * L) + B
        ops += OPS_K6_SEL * B * (2 * Lxn + 2 * L)
    return bound(ops, nbytes)


def k6c_bound(B, L, Lxn, Lh, n_narrow):
    """K6c's bound: d1 and beta read once from the pass each lane takes
    (n_narrow lanes at Lxn limbs, the rest at L), the three masks, and d1,
    beta at L, fits8, rare, d1_8 and the two Lh rows written once; without
    a narrow pass (Lxn = 0) d1 read from the wide pass and d1, beta not
    written. OPS_K6_SEL an output limb."""
    rd = 2 * (n_narrow * Lxn + (B - n_narrow) * L) if Lxn else B * L
    wr = B * ((2 * L if Lxn else 0) + 8 + 2 * Lh)
    return bound(OPS_K6_SEL * wr, 4.0 * (rd + wr) + B * (5 if Lxn else 4))


def k6d_bound(B, W8, Lh, n_fits8):
    """K6d's bound: each lane's two rows read once from the pipeline fits8
    picks (W8 limbs where it is set, Lh elsewhere), the mask, and g and
    eta0 written once at Lh; OPS_K6_SEL an output limb."""
    rd = 2 * (n_fits8 * W8 + (B - n_fits8) * Lh)
    return bound(OPS_K6_SEL * 2 * B * Lh, 4.0 * (rd + 2 * B * Lh) + B)


def k6e_bound(B, L, Lm):
    """K6e's bound: a3 and csum read once, the two Lm rows written once;
    OPS_K6E an output limb and one a staged limb."""
    return bound(B * (OPS_K6E * 2 * Lm + L + Lm), 4.0 * B * (L + 3 * Lm))


def check_k6a(torch, cgp, lb, own, B):
    """K6a at B lanes and widths K6A_W on k6a_cases' sums, with the shifted
    output (>> 1 at W) and two sums in one launch: bit-exact against its
    plain version on every lane and against Python integers on the first
    256. Returns {W: numbers} of the two-term sums (no shift)."""
    out = {}
    for W in K6A_W:
        cases = k6a_cases(torch, lb, own, W, B)
        for label, terms, vals in cases:
            got = cgp.canon_sm_cuda(terms, W, shr=1, W_shr=W)
            err = max_abs_diff(torch, got, cgp.canon_sm_plain(terms, W, shr=1, W_shr=W))
            if err:
                fail(f"K6a W={W} B={B} ({label}) differs from its plain version (max {err})")
            n = len(vals)
            if got[0][:n].tolist() != [_sgn(v) for v in vals] \
                    or lb.limbs_to_ints(got[1][:n].cpu()) != [abs(v) for v in vals] \
                    or lb.limbs_to_ints(got[2][:n].cpu()) != [abs(v) >> 1 for v in vals]:
                fail(f"K6a W={W} B={B} ({label}) differs from Python integers")
        (_, t2, _), (_, t3, _), _ = cases
        pair = cgp.canon_sm_cuda(t2, W, terms2=t3)
        if max_abs_diff(torch, [*pair[0], *pair[1]],
                        [*cgp.canon_sm_cuda(t2, W), *cgp.canon_sm_cuda(t3, W)]):
            fail(f"K6a W={W} B={B}: two sums in one launch differ from one at a time")
        ms = timed(torch, lambda: cgp.canon_sm_cuda(t2, W), TIMING_REPS)
        plain_ms = timed(torch, lambda: cgp.canon_sm_plain(t2, W), 1, warm=False)
        bms, by = k6a_bound(B, W, [t2])
        log(f"K6a canon_sm W={W} B={B}: {', '.join(c[0] for c in cases)} (edge rows "
            f"first), >> 1 and two sums a launch: bit-exact vs plain and Python "
            f"integers; two terms: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bms:.5f} ms ({by}, {bms / ms:.1%} of it)")
        out[W] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)
    return out


def k6b_operands(cg, gmp, hsm, port, own, B):
    """B compose2 operand pairs of random powers of h with, every eighth
    lane of the first 96, an identity on the left, on the right and on
    both, a self-compose, an inverse pair and powers of f on either side
    (even a: F2 rotated)."""
    from cofhe_tpu_torch.core.qfi import identity_form, neg, reduce_form

    base = gmp.nupow_batch([hsm.h] * 16, [own.getrandbits(1100) for _ in range(16)])
    f1 = [base[own.randrange(16)] for _ in range(B)]
    f2 = [base[own.randrange(16)] for _ in range(B)]
    ident = identity_form(hsm.Delta)
    for i in range(0, min(B, 96), 8):
        f1[i] = ident
        f2[i + 1] = ident
        f1[i + 2] = f2[i + 2] = ident
        f1[i + 3] = f2[i + 3]
        f1[i + 4] = reduce_form(neg(f2[i + 4]))
        f1[i + 5] = hsm.power_of_f(own.getrandbits(K))
        f2[i + 6] = hsm.power_of_f(own.getrandbits(K))
    return f1, f2


def _rand_bits(own, bits: int) -> int:
    """A random integer of exactly `bits` bits (0 for 0)."""
    return own.getrandbits(bits) | (1 << (bits - 1)) if bits > 0 else 0


def k6b_wide_forms(torch, lb, own, cg, B):
    """K6b's operands for the first gcd's select at B lanes: a rows of nb -
    1, nb and nb + 1 bits (nb = 16 Lxn - 32) on either side, then random
    ones around nb (no reduced form at sec=128 passes nb, so the compose2
    operands take the narrow pass on every lane); b below 2^(16 Lh - 2)
    with random signs, c random. Returns (F1, F2, h, h2, Lh, Lxn)."""
    from cofhe_tpu_torch.ops.forms import BForm

    L, Lh, nb = cg.L, cg.Lh, 16 * cg.Lxn - 32
    edge = (nb - 1, nb, nb + 1)
    bits = [(x, y) for x in edge for y in edge]
    bits += [(own.randrange(nb - 64, nb + 64), own.randrange(nb - 64, nb + 64))
             for _ in range(B - len(bits))]

    def form(k):
        a = _limbs(torch, lb, [_rand_bits(own, x[k]) for x in bits[:B]], L)
        b = _limbs(torch, lb, [own.getrandbits(16 * Lh - 2) for _ in range(B)], L)
        c = _limbs(torch, lb, [own.getrandbits(16 * L - 2) for _ in range(B)], L)
        sg = torch.tensor([own.choice((-1, 1)) for _ in range(B)], dtype=torch.int32,
                          device="cuda")
        return BForm(a, sg, b, c)

    return form(0), form(1), cg.h, cg.h2, Lh, cg.Lxn


def check_k6b(torch, cgp, lb, cg, gmp, hsm, port, own, B):
    """K6b on k6b_operands at B lanes, with the first gcd's operands (Lxn <
    L): bit-exact against its plain version
    (compose2_plain.compose2_prologue_plain), with identity, swapped and
    rotated lanes live; and on k6b_wide_forms, where the first gcd's select
    takes both sides. Returns its numbers."""
    f1, f2 = k6b_operands(cg, gmp, hsm, port, own, B)
    b1, b2 = (port.bform_from_forms(f, cg.L, "cuda") for f in (f1, f2))
    args = (b1, b2, cg.h, cg.h2, cg.Lh, cg.Lxn)
    got = cgp.compose_prologue_cuda(*args)
    err = max_abs_diff(torch, got, cgp.compose_prologue_plain(*args))
    if err or len(got) != 19:
        fail(f"K6b L={cg.L} Lxn={cg.Lxn} B={B} differs from its plain version (max "
             f"{err}, {len(got)} outputs)")
    wide = k6b_wide_forms(torch, lb, own, cg, B)
    gw = cgp.compose_prologue_cuda(*wide)
    err = max_abs_diff(torch, gw, cgp.compose_prologue_plain(*wide))
    narrow = int(gw[14].sum())
    if err or not 0 < narrow < B:
        fail(f"K6b B={B}: on wide a rows it differs from its plain version (max {err}) "
             f"or the first gcd's select is one-sided ({narrow} narrow lanes of {B})")
    if [got[12].tolist(), got[13].tolist()] != [[f.a == 1 for f in fs] for fs in (f1, f2)]:
        fail(f"K6b B={B}: the identity masks are wrong")
    live = [(x.a, y.a) for x, y in zip(f1, f2) if x.a != 1 and y.a != 1]
    ids = B - len(live)
    swapped = sum(x > y for x, y in live)
    rotated = sum(max(x, y) % 2 == 0 for x, y in live)
    if not (ids and swapped and rotated):
        fail(f"K6b B={B}: identity ({ids}), swapped ({swapped}) or rotated ({rotated}) "
             f"lanes missing")
    ms = timed(torch, lambda: cgp.compose_prologue_cuda(*args), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.compose_prologue_plain(*args), 1, warm=False)
    bms, by = k6b_bound(B, cg.L, cg.Lh, cg.Lxn)
    log(f"K6b compose_prologue L={cg.L} Lh={cg.Lh} Lxn={cg.Lxn} B={B}: bit-exact vs "
        f"plain ({ids} identity lanes, {swapped} swapped, {rotated} rotated; on wide a "
        f"rows {narrow} narrow and {B - narrow} wide lanes); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bms:.5f} ms ({by}, {bms / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


def k6c_operands(torch, lb, own, cg, B):
    """K6c's operands at compose2's widths on B lanes: d1 = 2^120 - 1, 2^120,
    2^119, 2^121 + 1 and 1 on five narrow lanes and on five wide ones, then
    random bit lengths up to each pass's width, fx random; beta random;
    identity lanes on either side. Returns (d1_w, beta_w, id1, id2, Lh,
    (d1_n, beta_n, fx))."""
    L, Lxn, Lh = cg.L, cg.Lxn, cg.Lh
    edge = [(1 << 120) - 1, 1 << 120, 1 << 119, (1 << 121) + 1, 1]

    def d1s(W):
        return (edge * 2 + [_rand_bits(own, own.randrange(1, 16 * W + 1))
                            for _ in range(B)])[:B]

    def rand(W):
        return _limbs(torch, lb, [own.getrandbits(own.randrange(1, 16 * W + 1))
                                      for _ in range(B)], W)

    def mask(p, head=()):
        vals = list(head) + [own.random() < p for _ in range(B - len(head))]
        return torch.tensor(vals[:B], dtype=torch.bool, device="cuda")

    fx = mask(0.5, [True] * 5 + [False] * 5)
    return (_limbs(torch, lb, d1s(L), L), rand(L), mask(0.1), mask(0.1), Lh,
            (_limbs(torch, lb, d1s(Lxn), Lxn), rand(Lxn), fx))


def check_k6c(torch, cgp, lb, own, cg, B):
    """K6c on k6c_operands at B lanes, with and without the narrow pass:
    bit-exact against its plain version (compose2_plain.gcd_bridge_plain),
    and d1, fits8 and rare against Python integers on the first 256 lanes,
    both sides of 2^120 and rare lanes live. Returns its numbers."""
    args = k6c_operands(torch, lb, own, cg, B)
    wide = args[:5] + (None,)
    got = cgp.gcd_bridge_cuda(*args)
    err = max(max_abs_diff(torch, got, cgp.gcd_bridge_plain(*args)),
              max_abs_diff(torch, cgp.gcd_bridge_cuda(*wide), cgp.gcd_bridge_plain(*wide)))
    if err:
        fail(f"K6c L={cg.L} Lxn={cg.Lxn} B={B} differs from its plain version (max {err})")
    n = min(B, 256)
    d1_w, _, id1, id2, _, (d1_n, _, fx) = args
    d1 = [x if f else y for x, y, f in zip(lb.limbs_to_ints(d1_n[:n].cpu()),
                                           lb.limbs_to_ints(d1_w[:n].cpu()), fx[:n].tolist())]
    fits = [v < 1 << 120 for v in d1]
    ids = [x or y for x, y in zip(id1[:n].tolist(), id2[:n].tolist())]
    if lb.limbs_to_ints(got[0][:n].cpu()) != d1 or got[2][:n].tolist() != fits \
            or got[3][:n].tolist() != [not f and not i for f, i in zip(fits, ids)]:
        fail(f"K6c B={B}: d1, fits8 or rare differ from Python integers")
    if all(fits) or not any(fits) or not got[3].any():
        fail(f"K6c B={B}: fits8 one-sided or no rare lane")
    ms = timed(torch, lambda: cgp.gcd_bridge_cuda(*args), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.gcd_bridge_plain(*args), 1, warm=False)
    bms, by = k6c_bound(B, cg.L, cg.Lxn, cg.Lh, int(fx.sum()))
    log(f"K6c gcd_bridge L={cg.L} Lxn={cg.Lxn} Lh={cg.Lh} B={B}: bit-exact vs plain "
        f"(with and without the narrow pass) and Python integers ({int(fx.sum())} narrow "
        f"lanes, {int(got[2].sum())} fits8, {int(got[3].sum())} rare); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms, bound {bms:.5f} ms ({by}, {bms / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


def check_k6d(torch, cgp, lb, own, cg, B):
    """K6d at compose2's widths on B lanes: g8, eta0_8 below 2^128, gF,
    eta0F below 2^(16 Lh), fits8 random; bit-exact against its plain
    version (compose2_plain.gcd2_merge_plain) and against Python integers
    on the first 256 lanes. Returns its numbers."""
    Lh = cg.Lh

    def rand(W):
        return [own.getrandbits(own.randrange(1, 16 * W + 1)) for _ in range(B)]

    vals = [rand(8), rand(8), rand(Lh), rand(Lh)]
    fits8 = torch.tensor([own.random() < 0.5 for _ in range(B)], dtype=torch.bool,
                         device="cuda")
    args = (*(_limbs(torch, lb, v, w) for v, w in zip(vals, (8, 8, Lh, Lh))), fits8)
    got = cgp.gcd2_merge_cuda(*args)
    err = max_abs_diff(torch, got, cgp.gcd2_merge_plain(*args))
    if err:
        fail(f"K6d Lh={Lh} B={B} differs from its plain version (max {err})")
    n = min(B, 256)
    f = fits8[:n].tolist()
    for k, out in enumerate(got):
        if lb.limbs_to_ints(out[:n].cpu()) != [x if s else y for x, y, s in
                                                zip(vals[k][:n], vals[k + 2][:n], f)]:
            fail(f"K6d B={B}: {('g', 'eta0')[k]} differs from Python integers")
    ms = timed(torch, lambda: cgp.gcd2_merge_cuda(*args), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.gcd2_merge_plain(*args), 1, warm=False)
    bms, by = k6d_bound(B, 8, Lh, int(fits8.sum()))
    log(f"K6d gcd2_merge Lh={Lh} B={B}: bit-exact vs plain and Python integers "
        f"({int(fits8.sum())} fits8 lanes); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {bms:.5f} ms ({by}, {bms / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


def check_k6e(torch, cgp, lb, own, cg, B):
    """K6e at compose2's widths (a3 at L, csum at Lm) on B lanes: a3 with
    e = 0, 15, 16, 32, 16 L - 1 and a zero a3 first, then random a3 with
    random trailing zeros; csum random, one lane all 0xFFFF. Bit-exact
    against its plain version (compose2_plain.c3_operands_plain) and
    against Python integers on the first 256 lanes. Returns its numbers."""
    L, Lm = cg.L, cg.Lm
    a3 = [1 << e for e in (0, 15, 16, 32, 16 * L - 1)] + [0]
    a3 += [((own.getrandbits(16 * L) | 1) << own.randrange(16 * L)) % (1 << (16 * L))
           for _ in range(B - len(a3))]
    cs = [own.getrandbits(16 * Lm) for _ in range(B)]
    cs[1] = (1 << (16 * Lm)) - 1
    args = (_limbs(torch, lb, a3, L), _limbs(torch, lb, cs, Lm))
    got = cgp.c3_operands_cuda(*args)
    err = max_abs_diff(torch, got, cgp.c3_operands_plain(*args))
    if err:
        fail(f"K6e L={L} Lm={Lm} B={B} differs from its plain version (max {err})")
    n = min(B, 256)
    es = [(v & -v).bit_length() - 1 if v else 16 * L for v in a3[:n]]
    if lb.limbs_to_ints(got[0][:n].cpu()) != [c >> min(e, 16 * Lm - 1)
                                              for c, e in zip(cs, es)] \
            or lb.limbs_to_ints(got[1][:n].cpu()) != [(v >> e) % (1 << (16 * Lm))
                                                      for v, e in zip(a3, es)]:
        fail(f"K6e B={B}: differs from Python integers")
    ms = timed(torch, lambda: cgp.c3_operands_cuda(*args), TIMING_REPS)
    plain_ms = timed(torch, lambda: cgp.c3_operands_plain(*args), 1, warm=False)
    bms, by = k6e_bound(B, L, Lm)
    log(f"K6e c3_operands L={L} Lm={Lm} B={B}: bit-exact vs plain and Python integers "
        f"(e = 0, 15, 16, 32, 16 L - 1 and a zero a3 first); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bms:.5f} ms ({by}, {bms / ms:.1%} of it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=0)


# ------------------------------------------- main-path operands and launches


class Recorder:
    """Wraps the kernel wrappers of cuda_group (all thirteen, or the chosen
    ones): keeps the operands of the first eager call at each (kernel,
    width, extra, batch) key in the chosen (phase, batch) pairs. A graph
    replay calls no wrapper and a capture runs no kernel, so operands come
    from eager calls only (a graph's warm-up is one); cuda_group counts the
    launches by key itself. Not part of the package; removed after the
    run."""

    WANT = {("decrypt", 128), ("matmul", 256), ("matmul", 16384)}

    @staticmethod
    def wrappers(cgp) -> list:
        """The thirteen kernel wrappers, in cuda_group.KERNELS' order."""
        return [cgp.DISPATCH[k].name + "_cuda" for k in cgp.KERNELS]

    def __init__(self, torch, cgp, want=None, wrappers=None):
        self.torch, self.cgp = torch, cgp
        self.want = self.WANT if want is None else want
        self.phase = None
        self.ops: dict = {}
        self.orig = {n: getattr(cgp, n) for n in (wrappers or self.wrappers(cgp))}

    def _clone(self, a):
        """a copy of an argument: tensors cloned, also inside tuples (a
        BForm) and lists (a K6a sum's terms)."""
        if isinstance(a, self.torch.Tensor):
            return a.clone()
        if isinstance(a, list):
            return [self._clone(x) for x in a]
        if isinstance(a, tuple):
            vals = [self._clone(x) for x in a]
            return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
        return a

    def _note(self, key, args):
        if (self.phase, key[3]) in self.want and key not in self.ops \
                and not self.torch.cuda.is_current_stream_capturing():
            self.ops[key] = self._clone(tuple(args))

    def __enter__(self):
        rec, orig = self, self.orig

        def xgcd(f, g, m, nbits, need_u=False, iters=None):
            rec._note(("xgcd_coeff_g", f.shape[1], nbits, f.shape[0]), (f, g, m, nbits))
            return orig["xgcd_coeff_g_cuda"](f, g, m, nbits, need_u=need_u, iters=iters)

        def mod(x, m, max_iters, iters=None):
            rec._note(("mod_topdown", x.shape[1], m.shape[1], x.shape[0]),
                      (x, m, max_iters))
            return orig["mod_topdown_cuda"](x, m, max_iters, iters=iters)

        def red(a, b, c, dD_mant, dD_top, red_iters, iters=None):
            rec._note(("reduce2_grouped", a.shape[1], 0, a.shape[0]),
                      (a, b, c, dD_mant, dD_top, red_iters))
            return orig["reduce2_grouped_loop_cuda"](a, b, c, dD_mant, dD_top,
                                                     red_iters, iters=iters)

        def exact(a, b, c, max_iters, iters=None):
            rec._note(("reduce_exact", a.shape[1], 0, a.shape[0]), (a, b, c, max_iters))
            return orig["reduce_exact_cuda"](a, b, c, max_iters, iters=iters)

        def mul(ma, mb, L_out=None):
            Lo = ma.shape[-1] + mb.shape[-1] if L_out is None else L_out
            rec._note(("mag_mul", Lo, f"{ma.shape[-1]}x{mb.shape[-1]}",
                       math.prod(ma.shape[:-1])), (ma, mb, Lo))
            return orig["mag_mul_cuda"](ma, mb, L_out)

        def quo(x, y, L_out, inv=None):
            rec._note(("divexact_odd", L_out, f"{x.shape[-1]}x{y.shape[-1]}",
                       math.prod(x.shape[:-1])), (x, y, L_out))
            return orig["mag_divexact_odd_cuda"](x, y, L_out)

        def redc(x, d, steps, active=None, inv=None):
            rec._note(("redc_mod", x.shape[1], d.shape[1], x.shape[0]),
                      (x, d, steps, active))
            return orig["redc_mod_cuda"](x, d, steps, active)

        def walk(r0, r1, stop, max_groups, sim_steps=8, active=None, iters=None):
            rec._note(("lehmer_euclid", r0.shape[1], int(max_groups), r0.shape[0]),
                      (r0, r1, stop, max_groups, active))
            return orig["lehmer_euclid_cuda"](r0, r1, stop, max_groups,
                                              sim_steps=sim_steps, active=active,
                                              iters=iters)

        def canon(terms, W, shr=0, W_shr=None, terms2=None):
            rec._note(rec.cgp.canon_sm_key(terms, W, shr, W_shr, terms2),
                      (terms, W, shr, W_shr, terms2))
            return orig["canon_sm_cuda"](terms, W, shr=shr, W_shr=W_shr, terms2=terms2)

        def prologue(F1, F2, h, h2, Lh, Lxn=None):
            L = F1.a.shape[1]
            rec._note(("compose_prologue", L, f"{Lh},Lxn={Lxn}" if Lxn is not None
                       and Lxn < L else Lh, F1.a.shape[0]), (F1, F2, h, h2, Lh, Lxn))
            return orig["compose_prologue_cuda"](F1, F2, h, h2, Lh, Lxn)

        def bridge(d1_w, beta_w, id1, id2, Lh, narrow=None):
            Lxn = 0 if narrow is None else narrow[0].shape[1]
            rec._note(("gcd_bridge", d1_w.shape[1], f"Lxn={Lxn},Lh={Lh}", d1_w.shape[0]),
                      (d1_w, beta_w, id1, id2, Lh, narrow))
            return orig["gcd_bridge_cuda"](d1_w, beta_w, id1, id2, Lh, narrow)

        def merge(g8, eta0_8, gF, eta0F, fits8):
            rec._note(("gcd2_merge", gF.shape[1], g8.shape[1], g8.shape[0]),
                      (g8, eta0_8, gF, eta0F, fits8))
            return orig["gcd2_merge_cuda"](g8, eta0_8, gF, eta0F, fits8)

        def c3(a3, csum):
            rec._note(("c3_operands", csum.shape[1], a3.shape[1], a3.shape[0]), (a3, csum))
            return orig["c3_operands_cuda"](a3, csum)

        new = {"xgcd_coeff_g_cuda": xgcd, "mod_topdown_cuda": mod,
               "reduce2_grouped_loop_cuda": red, "reduce_exact_cuda": exact,
               "mag_mul_cuda": mul, "mag_divexact_odd_cuda": quo, "redc_mod_cuda": redc,
               "lehmer_euclid_cuda": walk, "canon_sm_cuda": canon,
               "compose_prologue_cuda": prologue, "gcd_bridge_cuda": bridge,
               "gcd2_merge_cuda": merge, "c3_operands_cuda": c3}
        for n in self.orig:
            setattr(self.cgp, n, new[n])
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cgp, n, fn)
        return False


# ---------------------------------------------------------------- the path


# kernels run by 'kernel@batch', counted apart from cuda_group's counters
# (tools/mesh_check.count_calls: eager dispatcher calls and each replay's
# captured kernels); installed by main()
CALLS: dict = {}


def reset_counts(cgp) -> None:
    """Set the launch counts, and the count kept apart from them, to 0."""
    cgp.reset_launches()
    CALLS.clear()


def k6_kernels(cgp) -> tuple:
    """K6a-K6e, compose2's fused kernels, by the labels of cuda_group's
    dispatch table."""
    return tuple(k for k, d in cgp.DISPATCH.items() if d.label.startswith("K6"))


def eager_cg(cg):
    """`cg` with compose2 and the wNAF ladder run eagerly on the card: the
    bodies every capture runs (CG.compose2_eager, graphs.LadderSteps), set
    on this instance alone. Returns it."""
    from cofhe_tpu_torch.ops.graphs import LadderSteps

    cg.compose2 = cg.compose2_eager
    cg.compose_graphs.run_ladder = \
        lambda bank, r, sched: LadderSteps(cg, bank, r).run(bank, r, sched)
    return cg


def path_kernels(cgp, nucomp: bool = False) -> list:
    """The kernels a path must launch: all thirteen where it takes the
    NUCOMP tail (the legacy path), else all but K7, the tail's Lehmer walk
    (K6a-K6e run in every compose2)."""
    return [n for n in cgp.KERNELS if nucomp or n != "lehmer_euclid"]


def check_path_launches(cgp, path: str, nucomp: bool = False):
    """Every kernel of the path (path_kernels) launched in `path`'s run
    (graph replays counted), and cuda_group's counts by (kernel, batch)
    equal to CALLS, counted apart from them; returns (launches, launches
    by key)."""
    launches, by_key = dict(cgp.LAUNCHES), dict(cgp.LAUNCHES_BY_KEY)
    for name in path_kernels(cgp, nucomp):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path}")
    by_batch: dict = {}
    for (name, _, _, batch), n in by_key.items():
        by_batch[f"{name}@{batch}"] = by_batch.get(f"{name}@{batch}", 0) + n
    if by_batch != CALLS or any(
            n != sum(v for k, v in CALLS.items() if k.split("@")[0] == name)
            for name, n in launches.items()):
        fail(f"the {path}'s launch counts {json.dumps(by_batch)} disagree with the "
             f"dispatcher calls and graph replays {json.dumps(CALLS)}")
    log(f"{path} launches: " + json.dumps(launches))
    log(f"{path} launches by (kernel, width, extra, batch): " + json.dumps(
        {",".join(map(str, k)): v for k, v in sorted(by_key.items())}))
    return launches, by_key


def report_graphs(cg, label: str) -> None:
    """Each compose2 graph of `cg`: batch, warm-up and capture seconds,
    the memory its capture reserved, replays."""
    for (dev, B, L), g in sorted(cg.compose_graphs.graphs.items(), key=lambda x: x[0][1]):
        log(f"graph {label} B={B} L={L} on {dev}: warm-up {g.warmup_s:.3f} s, capture "
            f"{g.capture_s:.3f} s, memory_reserved {g.reserved_before / 2**20:.1f} -> "
            f"{g.reserved_after / 2**20:.1f} MiB (pool {g.pool_bytes / 2**20:.1f} MiB), "
            f"{len(g.keys)} kernel launches a replay, {g.replays} replays")


def run_slice(torch, cgp, rec, CryptoSystem, Tensor, GmpEngine, rng):
    """encrypt -> homomorphic matmul -> decrypt at sec=128, k=128."""
    from cofhe_tpu_torch.utils import trace
    from cofhe_tpu_torch.utils.benchmark import PhaseTimer

    timer = PhaseTimer("cuda")
    phases = timer.phases
    with timer("setup_keygen_s"):
        cs = CryptoSystem(SEC, K, device="cuda", seed=b"chip-smoke")
        sk = cs.keygen()
        pk = cs.keygen(sk)
    M = cs.hsm2k.M
    ctv = [rng.randrange(M) for _ in range(N_ROWS * M_INNER)]
    sv = [rng.randrange(M) for _ in range(M_INNER * P_COLS)]
    pt = Tensor(sv, (M_INNER, P_COLS))

    reset_counts(cgp)
    with rec:
        rec.phase = "encrypt"
        with timer("encrypt_s"):
            ct = cs.encrypt_tensor(pk, Tensor(ctv, (N_ROWS, M_INNER)))
            torch.cuda.synchronize()
        # the facade draws the matmul's Enc(0) from its generator: a copy of
        # the generator replays it for the host check below
        rand_at_matmul = copy.deepcopy(cs.rand_gen)
        rec.phase = "matmul"
        # traced: the matmul then fills last_matmul_phases
        with timer("matmul_s"), trace.enabled():
            res = cs.scal_ciphertext_tensors(pk, pt, ct)
            torch.cuda.synchronize()
        phases.update({f"matmul_{k}": v
                       for k, v in cs._engine.last_matmul_phases.items()})
        rec.phase = "decrypt"
        with timer("decrypt_s"):
            dec = cs.decrypt_tensor(sk, res)
            torch.cuda.synchronize()
    launches, by_key = check_path_launches(cgp, "main path")
    report_graphs(cs._engine.cg, "main path")

    for i in range(N_ROWS):
        for kk in range(P_COLS):
            want = sum(ctv[i * M_INNER + j] * sv[j * P_COLS + kk]
                       for j in range(M_INNER)) % M
            if dec.at(i, kk) != want:
                fail(f"decrypted ({i}, {kk}) != integer matmul mod 2^{K}")
    from cofhe_tpu_torch.core.qfi import is_reduced

    if not all(is_reduced(f) for c in res.data for f in c):
        fail("a matmul output form is not reduced")

    # bit-identity with the GMP host backend: ct row 0 x pt[:, :2] with the
    # same Enc(0) must give the main path's res[0, 0] and res[0, 1]
    with timer("gmp_check_s"):
        zero = cs.hsm2k.encrypt(pk, 0, copy.deepcopy(rand_at_matmul))
        row0 = Tensor([ct.at(0, j) for j in range(M_INNER)], (1, M_INNER))
        pt2 = Tensor([sv[j * P_COLS + kk] for j in range(M_INNER) for kk in range(2)],
                     (M_INNER, 2))
        host_out = GmpEngine(cs.hsm2k).scal_matmul(pt2, row0, zero)
        if list(host_out.data) != [res.at(0, 0), res.at(0, 1)]:
            fail("matmul ciphertexts differ from the GMP host backend's")
    log(f"slice ct({N_ROWS}x{M_INNER}) x pt({M_INNER}x{P_COLS}) at sec={SEC} k={K}: "
        f"{N_ROWS * P_COLS} plaintexts correct, every output form reduced, "
        f"2 ciphertexts bit-identical to GMP")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    return launches, by_key, dict(cs=cs, sk=sk, pk=pk, ct=ct, ctv=ctv, pt=pt, res=res,
                                  zero=zero, dec=dec, rand_at_matmul=rand_at_matmul)


def compare_decrypt(torch, cgp, port, rec, main):
    """The main path's 128 ciphertexts decrypted once more by graph replays
    (the main engine, its graphs captured) and once by an eager engine:
    the c1^sk forms and the plaintexts must be bit-identical, and equal to
    the main path's, and every kernel's launch count equal. The eager run
    records the decrypt operands."""
    from cofhe_tpu_torch.core.qfi import neg, reduce_form

    cs, sk, res = main["cs"], main["sk"], main["res"]
    cts = list(res.data)
    runs = {}
    eager = port.TorchEngine(cs.hsm2k, "cuda")
    eager_cg(eager.cg)
    for label, eng in (("graph", cs._engine), ("eager", eager)):
        reset_counts(cgp)
        rec.phase = "decrypt"
        with rec if label == "eager" else contextlib.nullcontext():
            t = time.perf_counter()
            c1sk = eng.part_decrypt_batch(sk, cts)
            fm = eng.compose_forms_batch([c.c2 for c in cts],
                                         [reduce_form(neg(f)) for f in c1sk])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        check_path_launches(cgp, f"{label} decrypt")
        pts = [cs.hsm2k.dlog_in_F(f) for f in fm]
        runs[label] = (c1sk, pts, secs, dict(cgp.LAUNCHES))
    (gf, gp, gs, gl), (ef, ep, es, el) = runs["graph"], runs["eager"]
    if gf != ef or gp != ep:
        fail("graph and eager decrypts of the same ciphertexts differ")
    if gp != list(main["dec"].data):
        fail("the graph decrypt differs from the main path's decrypt_tensor")
    if gl != el:
        fail(f"graph and eager decrypts launched different kernels: {gl} / {el}")
    log(f"decrypt of {len(cts)} ciphertexts, graph replays against eager on one card: "
        f"c1^sk forms and plaintexts bit-identical; graph {gs:.3f} s, eager {es:.3f} s "
        f"({es / gs:.2f}x); launches of each " + json.dumps(gl))
    return dict(graph_s=gs, eager_s=es)


def run_engine_ops(torch, cgp, port, main, rng):
    """add_ciphertext_vectors, scal_ciphertext_vector and the batched
    threshold combine on 64 of the main path's ciphertexts, against the
    GMP host engine."""
    from cofhe_tpu_torch.utils.benchmark import PhaseTimer

    cs, sk, pk, ct, ctv = (main[k] for k in ("cs", "sk", "pk", "ct", "ctv"))
    M = cs.hsm2k.M
    cts, others = ct.data[:ENGINE_N], ct.data[ENGINE_N:2 * ENGINE_N]
    scal = [0, 1, M - 1] + [rng.getrandbits(K) for _ in range(ENGINE_N - 3)]
    shares = cs.keygen(sk, 2, 3)
    sh = [shares[pm][port.liss.share_index_for_party(pm, (0, 1), 3)] for pm in (0, 1)]
    gmp = port.hostgmp.GmpEngine(cs.hsm2k)
    timer = PhaseTimer("cuda")
    phases = timer.phases
    reset_counts(cgp)
    with timer("add_s"):
        added = cs.add_ciphertext_vectors(pk, cts, others)
        torch.cuda.synchronize()
    with timer("scal_s"):
        scaled = cs.scal_ciphertext_vector(pk, scal, cts)
        torch.cuda.synchronize()
    pdrs = [gmp.part_decrypt_batch(s, scaled) for s in sh]
    with timer("combine_s"):
        combined = cs.combine_part_decryption_results_vector(scaled, pdrs)
        torch.cuda.synchronize()
    launches, _ = check_path_launches(cgp, "engine-ops path")
    if added != gmp.add_batch(cts, others):
        fail("add_ciphertext_vectors differs from GMP's add_batch")
    if scaled != gmp.scal_batch(scal, cts):
        fail("scal_ciphertext_vector differs from GMP's scal_batch")
    if combined != [s * v % M for s, v in zip(scal, ctv)]:
        fail("the batched threshold combine gave wrong plaintexts")
    phases["total_s"] = sum(v for k, v in phases.items() if k.endswith("_s"))
    log(f"engine ops on {ENGINE_N} ciphertexts at sec={SEC} k={K}: add and scal "
        f"bit-identical to GMP (scalars 0, 1, 2^{K} - 1 and random), combine of "
        f"t=2 part-decryptions correct; phase seconds: "
        + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    return launches, dict(cts=cts, others=others, added=added, shares=sh)


def run_mesh(torch, cgp, port, main, ops):
    """Two ranks of tools/mesh_check on a dp=1 x tp=2 mesh: the main
    path's matmul, the engine-ops path's adds and a t=2 combine over tp,
    each held to the single-card results. Returns the launches summed over
    the ranks."""
    from cofhe_tpu_torch.tools import mesh_check

    cs, ct = main["cs"], main["ct"]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MESH_RANKS else "gloo"
    gmp = port.hostgmp.GmpEngine(cs.hsm2k)
    comb_cts = ct.data[:MESH_COMBINE_N]
    pdrs = [gmp.part_decrypt_batch(s, comb_cts) for s in ops["shares"]]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "mesh_check")
    os.makedirs(out_dir, exist_ok=True)
    inputs = os.path.join(out_dir, "inputs.pkl")
    mesh_check.write_inputs(
        inputs, SEC, K, cs.hsm2k.p, add=(ops["cts"], ops["others"]),
        matmul=(ct, main["pt"], main["zero"]), combine=(comb_cts, pdrs),
        expect={"matmul": main["res"].data, "add": ops["added"],
                "combine": main["ctv"][:MESH_COMBINE_N]})
    log(f"mesh: {MESH_RANKS} ranks of tools.mesh_check, dp=1 x tp=2, backend "
        f"{backend}, cards " + ("one each" if backend == "nccl" else "cuda:0 shared")
        + f" ({cards} visible)")
    t = time.perf_counter()
    try:
        outs = mesh_check.launch(MESH_RANKS, inputs, out_dir, device="cuda",
                                 backend=backend, dp=1, tp=MESH_RANKS,
                                 timeout_s=MESH_TIMEOUT_S)
    except mesh_check.MeshCheckError as e:
        log(str(e))
        fail("a mesh rank failed (its output is above)")
    wall = time.perf_counter() - t
    problems = mesh_check.check_outputs(outs, inputs)
    if problems:
        fail("mesh: " + "; ".join(problems))
    for o in outs:
        k2 = {k: v for k, v in o["calls"].items() if k.startswith("mod_topdown@")}
        if not k2.get(f"mod_topdown@{MESH_LADDER_B}") or f"mod_topdown@{KERNEL_B}" in k2:
            fail(f"mesh rank {o['rank']}: K2 launches by batch {k2} do not show "
                 f"the shard's {MESH_LADDER_B}-lane ladder")
    launches = {name: sum(o["launches"][name] for o in outs) for name in cgp.KERNELS}
    for name, n in launches.items():
        if name in path_kernels(cgp) and (
                n <= 0 or any(o["launches"][name] <= 0 for o in outs)):
            fail(f"kernel {name} was not launched on every mesh rank")
        for o in outs:  # the launches against the rank's count apart from them
            if o["launches"][name] != sum(v for k, v in o["calls"].items()
                                          if k.split("@")[0] == name):
                fail(f"mesh rank {o['rank']}: {name} launches {o['launches'][name]} "
                     f"disagree with its dispatcher calls and replays {o['calls']}")
    for o in outs:
        log(f"mesh rank {o['rank']} at {o['coord']}: launches "
            + json.dumps(o["launches"]) + ", by kernel@batch " + json.dumps(o["calls"])
            + f", gathers {o['gathers']}, seconds "
            + json.dumps({k: round(v, 3) for k, v in o["seconds"].items()})
            + ", matmul " + json.dumps({k: round(v, 3) for k, v in o["matmul_phases"].items()}))
    log(f"mesh ({backend}, {MESH_RANKS} ranks) at sec={SEC} k={K}: matmul, {ENGINE_N} "
        f"adds and the t=2 combine of {MESH_COMBINE_N} bit-identical to the single-card "
        f"path on both ranks; wall {wall:.1f} s; launches summed " + json.dumps(launches))
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_network(torch, cgp, port, rng):
    """The 5-node threshold network in-process: a ct(4x4) . ct(4x4) Beaver
    matmul and a tensor ADD through the compute node, CoFHE node 0 on the
    card."""
    from cofhe_tpu_torch.node import nodes, wire
    from cofhe_tpu_torch.node.network_details import (CryptoSystemDetails,
                                                      NodeDetails, NodeType)

    phases = {}
    t = time.perf_counter()
    ports = [_free_port() for _ in range(5)]
    setup_nd = NodeDetails("127.0.0.1", str(ports[0]), NodeType.SETUP_NODE)
    details = CryptoSystemDetails(type="CoFHE_GPU", public_key="", security_level=SEC,
                                  k=K, threshold=2, total_nodes=3)
    servers, client, compute = [], None, None
    try:
        server, setup = nodes.make_setup_node(setup_nd, details, device="cuda")
        server.run_in_thread()
        servers.append(server)
        for i, dev in zip(range(1, 4), ("cuda", "host", "host")):
            nd = NodeDetails("127.0.0.1", str(ports[i]), NodeType.COFHE_NODE)
            servers.append(nodes.make_cofhe_node(nd, setup_nd, device=dev))
            servers[-1].run_in_thread()
        nd = NodeDetails("127.0.0.1", str(ports[4]), NodeType.COMPUTE_NODE)
        servers.append(nodes.make_compute_node(nd, setup_nd, device="cuda"))
        servers[-1].run_in_thread()
        node0, compute = servers[1].handler.__self__, servers[4].handler.__self__
        if node0.cs.device != "cuda" or compute.cs.device != "cuda":
            fail("CoFHE node 0 and the compute node must run on the card")
        client = nodes.ClientNode(setup_nd, use_tls=False, device="cuda")
        phases["start_s"] = time.perf_counter() - t

        # node 0's part-decryptions: size, seconds and the kernels they launched
        node0_calls = []
        pd_orig = node0.cs.part_decrypt_tensor

        def pd_spy(share, ct):
            before, t0 = dict(cgp.LAUNCHES), time.perf_counter()
            out = pd_orig(share, ct)
            torch.cuda.synchronize()
            node0_calls.append((len(ct.data), time.perf_counter() - t0, {
                k: cgp.LAUNCHES[k] - before[k] for k in before}))
            return out

        node0.cs.part_decrypt_tensor = pd_spy
        cs, pk = client.crypto_system, client.public_key
        M = cs.hsm2k.M
        n = NET_DIM
        xv = [rng.randrange(M) for _ in range(n * n)]
        yv = [rng.randrange(M) for _ in range(n * n)]
        ct1 = cs.encrypt_tensor(pk, port.Tensor(xv, (n, n)))
        ct2 = cs.encrypt_tensor(pk, port.Tensor(yv, (n, n)))
        ser = cs.serialize_ciphertext_tensor

        def request(op):
            resp = client.compute(wire.ComputeRequest(
                wire.ComputeOperationType.BINARY, op,
                [wire.ComputeOperand(wire.DataType.TENSOR,
                                     wire.DataEncryptionType.CIPHERTEXT, ser(c))
                 for c in (ct1, ct2)]))
            if resp.status != wire.Status.OK:
                fail(f"the compute node answered {op.name} with an error: "
                     f"{resp.data[:300]!r}")
            return cs.deserialize_ciphertext_tensor(resp.data)

        reset_counts(cgp)
        t = time.perf_counter()
        prod = request(wire.ComputeOperation.MULTIPLY)
        phases["multiply_s"] = time.perf_counter() - t
        t = time.perf_counter()
        summed = request(wire.ComputeOperation.ADD)
        phases["add_s"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches, by_key = check_path_launches(cgp, "network path")
        combo = compute.smpc._combo
    finally:
        if client is not None:
            client.close()
        if compute is not None:
            compute.smpc.close()
        for s in servers:
            s.stop()

    gmp = port.hostgmp.GmpEngine(setup.cs.hsm2k)
    got = gmp.decrypt_batch(setup.sk, prod.data)
    want = [sum(xv[i * n + j] * yv[j * n + k] for j in range(n)) % M
            for i in range(n) for k in range(n)]
    if prod.shape != (n, n) or got != want:
        fail("the network's Beaver matmul decrypts to the wrong plaintexts")
    if gmp.decrypt_batch(setup.sk, summed.data) != [(x + y) % M for x, y in zip(xv, yv)]:
        fail("the network's tensor ADD decrypts to the wrong plaintexts")
    if combo != (0, 1):
        fail(f"the opening round ran on CoFHE nodes {combo}, not (0, 1)")
    opened = [c for c in node0_calls if c[0] == OPENING_B]
    if not opened or any(opened[0][2][k] <= 0 for k in path_kernels(cgp)):
        fail(f"CoFHE node 0 did not part-decrypt the {OPENING_B}-ciphertext opening "
             f"on the card: {node0_calls}")
    at_opening = {}
    for key, v in by_key.items():
        if key[3] == OPENING_B:
            at_opening[key[0]] = at_opening.get(key[0], 0) + v
    phases["node0_part_decrypt_s"] = opened[0][1]
    phases["node0_launches"] = opened[0][2]
    log(f"network (1 setup, 3 CoFHE, 1 compute node, t=2, n=3) at sec={SEC} k={K}: "
        f"ct({n}x{n}) . ct({n}x{n}) Beaver matmul ({n ** 3} products, {OPENING_B} "
        f"openings) and tensor ADD correct; shares combined {combo}; CoFHE node 0 "
        f"answered on the card; launches at batch {OPENING_B} by kernel "
        + json.dumps(at_opening) + "; phase seconds: "
        + json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in phases.items()}))
    return launches


def run_legacy(torch, cgp, port, main, rng):
    """The opt-in and legacy code at full width on 128 of the main path's
    ciphertexts: NUCOMP compose2 / nudupl2 (graph replays, and eagerly),
    nupow_shared_wnaf2, the v1 compose_batch / nudupl_batch and xgcd_mod,
    each against GMP and the port's default paths. Returns the launches,
    the recorder (K3's operands at width Ln, K7's), the NUCOMP CGs and the
    profiles' Lehmer groups."""
    from cofhe_tpu_torch.ops import forms, xgcd
    from cofhe_tpu_torch.ops.nupow2 import nupow_shared_wnaf2, wnaf_digits
    from cofhe_tpu_torch.utils.benchmark import PhaseTimer

    cs = main["cs"]
    eng, hsm = cs._engine, cs.hsm2k
    cg = eng.cg
    gmp = port.hostgmp.GmpClassGroup(hsm.Delta)
    cts = main["ct"].data[:LEGACY_B]
    f1, f2 = [ct.c1 for ct in cts], [ct.c2 for ct in cts]
    b1 = port.bform_from_forms(f1, cg.L, "cuda")
    b2 = port.bform_from_forms(f2, cg.L, "cuda")
    ncg = port.f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    necg = eager_cg(port.f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True))
    spec = forms.FormSpec.for_disc_bits(cg.disc_bits)
    if spec.L != cg.L or ncg.Ln <= cg.L:
        fail(f"legacy widths: v1 L={spec.L}, compose2 L={cg.L}, Ln={ncg.Ln}")
    e = rng.getrandbits(LEGACY_EXP_BITS) | (1 << (LEGACY_EXP_BITS - 1))
    sched = wnaf_digits(e, 5)
    xf = [f.a if f.a & 1 else f.c for f in f2]  # odd, as compose's first xgcd
    xg = [f.a for f in f1]
    half = max(x.bit_length() for x in xf) // 2
    for i in range(8):  # lanes with a gcd above 1: (d*a, d*b), (f, 0), (f, f)
        d = rng.getrandbits(half // 2) | 1
        xf[i], xg[i] = d * (rng.getrandbits(half) | 1), d * rng.getrandbits(half)
    xg[8], xg[9] = 0, xf[9]
    timer = PhaseTimer("cuda")
    phases = timer.phases
    rec = Recorder(torch, cgp, want={("legacy", LEGACY_B)},
                   wrappers=Recorder.wrappers(cgp)[:4] + ["lehmer_euclid_cuda", "canon_sm_cuda"])
    rec.phase = "legacy"
    reset_counts(cgp)
    with rec, torch.inference_mode():
        with timer("nucomp_compose2_first_s"):  # eager warm-up, capture, replay
            ncg.compose2(b1, b2)
            torch.cuda.synchronize()
        with timer("nucomp_compose2_s"):
            nc = ncg.compose2(b1, b2)
            torch.cuda.synchronize()
        with timer("nucomp_nudupl2_s"):
            nd = ncg.nudupl2(b1)
            torch.cuda.synchronize()
        with timer("nucomp_compose2_eager_s"):
            nce = necg.compose2(b1, b2)
            torch.cuda.synchronize()
        with timer("nucomp_nudupl2_eager_s"):
            nde = necg.nudupl2(b1)
            torch.cuda.synchronize()
        with timer("shared_wnaf_s"):
            wn = nupow_shared_wnaf2(cg, b1, sched)
            torch.cuda.synchronize()
        with timer("v1_compose_s"):
            vc = forms.compose_batch(b1, b2, spec, cg.delta4)
            torch.cuda.synchronize()
        with timer("v1_nudupl_s"):
            vd = forms.nudupl_batch(b1, spec, cg.delta4)
            torch.cuda.synchronize()
        with timer("xgcd_mod_s"):
            xl = [torch.as_tensor(port.lb.ints_to_limbs(v, cg.L)).cuda()
                  for v in (xf, xg)]
            xo = xgcd.xgcd_mod(xl[0], xl[1], xl[0], spec.n_bits)
            torch.cuda.synchronize()
    launches, by_key = check_path_launches(cgp, "legacy path", nucomp=True)
    if len(ncg.compose_graphs.graphs) != 1:
        fail("the NUCOMP compose2 and nudupl2 did not replay one graph")
    for name in ("reduce2_grouped", "reduce_exact"):
        if not any(k[0] == name and k[1] == ncg.Ln for k in by_key):
            fail(f"the NUCOMP reduction did not launch {name} at width {ncg.Ln}")

    with timer("checks_s"), torch.inference_mode():
        want_c, want_d = gmp.compose_batch(f1, f2), gmp.nudupl_batch(f1)
        got = {"NUCOMP compose2": (nc, want_c), "NUCOMP nudupl2": (nd, want_d),
               "v1 compose_batch": (vc, want_c), "v1 nudupl_batch": (vd, want_d),
               "nupow_shared_wnaf2": (wn, gmp.nupow_batch(f1, [e] * LEGACY_B))}
        default = {"NUCOMP compose2": cg.compose2(b1, b2), "NUCOMP nudupl2": cg.nudupl2(b1)}
        default["v1 compose_batch"] = default["NUCOMP compose2"]
        default["v1 nudupl_batch"] = default["NUCOMP nudupl2"]
        default["nupow_shared_wnaf2"] = port.bform_from_forms(
            eng.part_decrypt_batch(e, cts), cg.L, "cuda")
        for name, eager in (("NUCOMP compose2", nce), ("NUCOMP nudupl2", nde)):
            if max_abs_diff(torch, got[name][0], eager):
                fail(f"legacy path: {name} by graph replay differs from eager")
        for name, (bf, want) in got.items():
            if port.bform_to_forms(bf) != want:
                fail(f"legacy path: {name} differs from GMP")
            if max_abs_diff(torch, bf, default[name]):
                fail(f"legacy path: {name} differs from the port's default path")
        d, u, v = (port.lb.limbs_to_ints(x.cpu()) for x in xo)
        for i, (f, g) in enumerate(zip(xf, xg)):
            if d[i] != math.gcd(f, g) or not (0 <= u[i] < f and 0 <= v[i] < f) \
                    or (u[i] * f + v[i] * g - d[i]) % f:
                fail(f"legacy path: xgcd_mod lane {i} gives a wrong gcd or Bezout pair")
    log(f"legacy path ({LEGACY_B} lanes at sec={SEC} k={K}): NUCOMP compose2 and "
        f"nudupl2 (K7, then K3 and KT at width {ncg.Ln}) by graph replay equal to "
        f"eager, nupow_shared_wnaf2 ({LEGACY_EXP_BITS}-bit "
        f"exponent, {len(sched)} digits, {sum(x != 0 for x in sched)} nonzero), the v1 "
        f"compose_batch / nudupl_batch equal to GMP and to the default paths; xgcd_mod "
        f"({sum(x > 1 for x in d)} lanes with d > 1) equal to math.gcd with its Bezout "
        f"identity mod m; phase seconds: "
        + json.dumps({k: (round(x, 3) if isinstance(x, float) else x)
                      for k, x in phases.items()}))
    report_graphs(ncg, "NUCOMP")
    seed = rng.getrandbits(64)  # every profile composes the same forms
    ecg = eager_cg(port.f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2))
    groups = None
    for c, label in ((ecg, "default tail, eager"), (cg, "default tail, graph replay"),
                     (necg, "NUCOMP tail, eager"), (ncg, "NUCOMP tail, graph replay")):
        groups = profile_compose(torch, c, gmp, hsm, port.bform_from_forms,
                                 random.Random(seed), label, groups=groups,
                                 sections=c in (ecg, necg))
    return launches, by_key, rec, ncg


def compare_nucomp(torch, cgp, port, main, ncg, rng):
    """NUCOMP against the default compose2, both by graph replay, on the
    same pairs of the main path's forms at NUCOMP_B lanes: equal outputs
    (the first 256 lanes equal to GMP), and the time a call on the card's
    clock (CUDA events around replays, copies and clones included) in turns
    default, NUCOMP, NUCOMP, default. Returns {B: (default ms, NUCOMP ms)}
    (each the mean of its two turns) and the recorder of K7's operands
    (one eager warm-up a batch)."""
    cs = main["cs"]
    cg = cs._engine.cg
    gmp = port.hostgmp.GmpClassGroup(cs.hsm2k.Delta)
    pool = [f for ct in main["ct"].data for f in (ct.c1, ct.c2)]
    rec = Recorder(torch, cgp, want={("nucomp", B) for B in NUCOMP_B},
                   wrappers=("lehmer_euclid_cuda",))
    rec.phase = "nucomp"
    out = {}
    for B in NUCOMP_B:
        f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
        f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
        b1 = port.bform_from_forms(f1, cg.L, "cuda")
        b2 = port.bform_from_forms(f2, cg.L, "cuda")
        before = cgp.LAUNCHES["lehmer_euclid"]
        with rec, torch.inference_mode():
            t = time.perf_counter()
            nc = ncg.compose2(b1, b2)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t
            if max_abs_diff(torch, nc, cg.compose2(b1, b2)):
                fail(f"NUCOMP compose2 B={B} differs from the default compose2")
            if port.bform_to_forms(nc)[:256] != gmp.compose_batch(f1[:256], f2[:256]):
                fail(f"NUCOMP compose2 B={B} differs from GMP's composes")
            reps = 5 if B == KERNEL_B else 20
            turns = {"default": [], "nucomp": []}
            for label in ("default", "nucomp", "nucomp", "default"):
                c = cg if label == "default" else ncg
                turns[label].append(timed(torch, lambda: c.compose2(b1, b2), reps))
        if cgp.LAUNCHES["lehmer_euclid"] - before < 2 * reps:
            fail(f"NUCOMP compose2 B={B}: K7 did not run in every replay")
        d_ms, n_ms = (sum(turns[k]) / 2 for k in ("default", "nucomp"))
        out[B] = (d_ms, n_ms)
        log(f"NUCOMP against default compose2 B={B}, by graph replay: outputs equal "
            f"(and to GMP); a call on the card's clock, turns default / NUCOMP / "
            f"NUCOMP / default {turns['default'][0]:.4f} / {turns['nucomp'][0]:.4f} / "
            f"{turns['nucomp'][1]:.4f} / {turns['default'][1]:.4f} ms: NUCOMP "
            f"{n_ms / d_ms:.3f}x the default; NUCOMP's first call (eager warm-up, "
            f"capture, replay) {first_s:.3f} s")
    report_graphs(ncg, "NUCOMP")
    return out, rec


# --------------------------------------------------------- the kernel table


def _stats(t) -> str:
    return f"mean {float(t.float().mean()):.2f} max {int(t.max())}"


def significant_limbs(torch, t):
    """1 + the index of each row's top nonzero limb (low 16 bits), 0 for zero."""
    t = t.reshape(-1, t.shape[-1])
    pos = torch.arange(1, t.shape[-1] + 1, device=t.device)
    return (((t & 0xFFFF) != 0).long() * pos).amax(dim=1)


def table_row(torch, cgp, f2m, cg, lb, key, args, n_launch):
    """One kernel at one recorded main-path shape and batch: checks, trip
    counts, time and bound. Returns its JSON entry."""
    name, W, extra, B = key
    iters = torch.zeros(B, dtype=torch.int32, device="cuda")
    row = {"name": row_name(key), "launches": n_launch, "library_ms": None}
    old_ops = trips = None
    if name in ("mag_mul", "divexact_odd", "redc_mod"):
        ms, plain_ms, (bms, by, row["bound_cuda_cores_ms"]), trips = limb_row(
            torch, cgp, lb, row, key, args)
    elif name in k6_kernels(cgp):
        ms, plain_ms, (bms, by), trips = k6_row(torch, cgp, lb, row, key, args)
    elif name == "xgcd_coeff_g":
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
    elif name == "lehmer_euclid":
        r0, r1, stop, mg, active = args
        iters = k7_compare(torch, cgp, row["name"], r0, r1, stop, mg, active)
        row["max_abs_err"] = 0
        fn = lambda: cgp.lehmer_euclid_cuda(r0, r1, stop, mg, active=active)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.lehmer_euclid_plain(
            r0, r1, stop, mg, active=active), 1, warm=False)
        ops = float(iters.long().sum()) * W * OPS_K7
        nbytes = 4.0 * B * (8 * W + 3)
    elif name == "reduce2_grouped":
        a, b, c, dD_mant, dD_top, red_iters = args
        got = cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters, iters=iters)
        plain = cgp.reduce2_grouped_loop_plain(a, b, c, dD_mant, dD_top, red_iters)
        row["max_abs_err"] = max_abs_diff(torch, got, plain)
        if max_abs_diff(torch, cg._tail(*got), cg._tail(*f2m.grouped_rho_loop(
                a, b, c, dD_mant, dD_top, red_iters))):
            fail(f"{row['name']}: differs from grouped_rho_loop after the tail")
        fn = lambda: cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.reduce2_grouped_loop_plain(
            a, b, c, dD_mant, dD_top, red_iters), 1, warm=False)
        limbs = float(iters.long().sum()) * W
        ops, old_ops = limbs * OPS_K3, limbs * OPS_K3_OLD
        nbytes = 4.0 * B * W * 6
    else:
        from cofhe_tpu_torch.core.qfi import Form, reduce_form
        from cofhe_tpu_torch.ops.forms import BForm, bform_to_forms

        a, b, c, max_iters = args
        got = cgp.reduce_exact_cuda(a, b, c, max_iters, iters=iters)
        row["max_abs_err"] = max_abs_diff(torch, got, cgp.reduce_exact_plain(
            a, b, c, max_iters))
        if int(iters.max()) > max_iters:
            fail(f"{row['name']}: a lane reached the cap of {max_iters} steps")
        n = min(B, 256)  # the Python oracle on the values of the first lanes
        vals = [lb.limbs_to_ints(lb.canonicalize_fast(x[:n].cpu())[1]) for x in (a, c)]
        sb, bm = lb.canonicalize_fast(b[:n].cpu())
        want = [reduce_form(Form(x, y, z)) for x, y, z in
                zip(vals[0], lb.limbs_to_ints(bm, sb), vals[1])]
        if bform_to_forms(BForm(*(x[:n] for x in got))) != want:
            fail(f"{row['name']}: differs from the Python oracle's reduced forms")
        fn = lambda: cgp.reduce_exact_cuda(a, b, c, max_iters)  # noqa: E731
        plain_ms = timed(torch, lambda: cgp.reduce_exact_plain(a, b, c, max_iters), 1,
                         warm=False)
        ops = float(iters.long().sum()) * W * OPS_KT
        nbytes = 4.0 * B * (6 * W + 2)
        row["tail_iters"] = int(iters.long().sum())
    if row["max_abs_err"]:
        fail(f"{row['name']}: differs from its plain version")
    if trips is None:
        ms = timed(torch, fn, TIMING_REPS)
        bms, by = bound(ops, nbytes)
        trips = k1_trips(iters, cgp.xgcd2.STEPS) if name == "xgcd_coeff_g" else _stats(iters)
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, trips=trips)
    if old_ops is not None:
        row["bound_old_counts_ms"] = bound(old_ops, nbytes)[0]
    log(f"table {row['name']}: launches {n_launch}, trips {row['trips']}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bms:.5f} ms ({by}, "
        f"{bms / ms:.1%} of it)"
        + (f", bound at the earlier per-limb counts {row['bound_old_counts_ms']:.5f} ms "
           f"({row['bound_old_counts_ms'] / ms:.1%} of it)" if old_ops is not None else "")
        + (f", bound with its products on CUDA cores {row['bound_cuda_cores_ms']:.5f} ms "
           f"({row['bound_cuda_cores_ms'] / ms:.1%} of it)"
           if "bound_cuda_cores_ms" in row else "")
        + (f", exact-tail steps in all {row['tail_iters']}" if "tail_iters" in row else "")
        + (f", oracle ok, {row['d_gt_1_lanes']} lanes with d > 1"
           if "d_gt_1_lanes" in row else ""))
    return row


def row_name(key) -> str:
    name, W, extra, B = key
    if name in ("mag_mul", "divexact_odd"):
        u, v = extra.split("x")
        shape = (f"La={u},Lb={v}" if name == "mag_mul" else f"Lx={u},Ly={v}") + f",L_out={W}"
    elif name == "redc_mod":
        shape = f"Lx={W},Ld={extra}"
    elif name in ("xgcd_coeff_g", "mod_topdown"):
        shape = f"W={W},{'nbits' if name == 'xgcd_coeff_g' else 'Lm'}={extra}"
    elif name == "lehmer_euclid":
        shape = f"L={W},max_groups={extra}"
    elif name == "canon_sm":
        shape = f"W={W},terms={extra}"
    elif name == "compose_prologue":
        shape = f"L={W},Lh={extra}"
    elif name == "gcd_bridge":
        shape = f"L={W},{extra}"
    elif name == "gcd2_merge":
        shape = f"Lh={W},W8={extra}"
    elif name == "c3_operands":
        shape = f"Lm={W},L={extra}"
    else:
        shape = f"W={W}"
    return f"{name}[{shape}]@B={B}"


def limb_row(torch, cgp, lb, row, key, args):
    """K5m, K5d or K4 at one recorded main-path shape and batch: against
    its plain version and Python integers; (ms, plain ms, bound, trips)."""
    name, W, _, B = key
    if name == "mag_mul":
        a, b, Lo = args
        got = cgp.mag_mul_cuda(a, b, Lo)
        plain = lambda: cgp.mag_mul_plain(a, b, Lo)  # noqa: E731
        fn = lambda: cgp.mag_mul_cuda(a, b, Lo)  # noqa: E731
        want = k5m_want(lb, a, b, Lo)
        bnd = k5m_bound(B, a.shape[-1], b.shape[-1], Lo)
        trips = f"no loop: {k5m_pairs(a.shape[-1], b.shape[-1], Lo)} limb products a row"
    elif name == "divexact_odd":
        x, y, Lo = args
        got = cgp.mag_divexact_odd_cuda(x, y, Lo)
        plain = lambda: cgp.mag_divexact_odd_plain(x, y, Lo)  # noqa: E731
        fn = lambda: cgp.mag_divexact_odd_cuda(x, y, Lo)  # noqa: E731
        want = k5d_want(lb, x, y, Lo, row["name"])
        bnd = k5d_bound(B, y.shape[-1], Lo)
        npt = -(-Lo // 32)
        trips = (f"{Lo} digits in {-(-Lo // npt)} block steps; y's significant "
                 f"limbs {_stats(significant_limbs(torch, y[..., :Lo]))}")
    else:
        x, d, steps, active = args
        got = cgp.redc_mod_cuda(x, d, steps, active)
        plain = lambda: cgp.redc_mod_plain(x, d, steps, active)  # noqa: E731
        fn = lambda: cgp.redc_mod_cuda(x, d, steps, active)  # noqa: E731
        want = k4_want(lb, x, d, steps, active, row["name"])
        bnd = k4_bound(B, W, d.shape[1], steps)
        npt = -(-(max(W, steps + d.shape[1]) + 1) // 32)
        nd = significant_limbs(torch, d if active is None else d[active])
        trips = (f"{steps} digits in {-(-steps // npt)} block steps, "
                 f"{B if active is None else int(active.sum())} active lanes; d's "
                 f"significant limbs on them "
                 + (_stats(nd) if nd.numel() else "none"))
    row["max_abs_err"] = max_abs_diff(torch, [got], [plain()])
    if lb.limbs_to_ints(got.cpu()) != want:
        fail(f"{row['name']}: differs from Python integers on the recorded operands")
    plain_ms = timed(torch, plain, 1, warm=False)
    return timed(torch, fn, TIMING_REPS), plain_ms, bnd, trips


def _flat(x) -> list:
    """The tensors of a kernel's output (nested tuples), in order."""
    return [t for y in x for t in _flat(y)] if isinstance(x, tuple) else [x]


def k6_row(torch, cgp, lb, row, key, args):
    """K6a, K6b, K6c, K6d or K6e at one recorded main-path call: against its
    plain version (K6a and K6e also against Python integers on the first
    256 lanes); (ms, plain ms, bound, trips)."""
    name, W, _, B = key
    if name == "canon_sm":
        terms, Wc, shr, W_shr, terms2 = args
        fn = lambda: cgp.canon_sm_cuda(terms, Wc, shr, W_shr, terms2)  # noqa: E731
        plain = lambda: cgp.canon_sm_plain(terms, Wc, shr, W_shr, terms2)  # noqa: E731
        rows = [terms] if terms2 is None else [terms, terms2]
        got = fn()
        n = min(B, 256)
        for ts, out in zip(rows, [got] if terms2 is None else got):
            vals = [0] * n
            for mag, sign, k in ts:
                # limbs may be redundant (the Lehmer cofactors): signed sums
                m = [sum(v << (16 * i) for i, v in enumerate(r))
                     for r in lb.resize(mag, Wc)[:n].tolist()]
                m = m * n if len(m) == 1 else m
                sg = [1] * n if sign is None else sign[:n].tolist()
                vals = [v + k * s_ * x for v, s_, x in zip(vals, sg, m)]
            if out[0][:n].tolist() != [_sgn(v) for v in vals] \
                    or lb.limbs_to_ints(out[1][:n].cpu()) != [abs(v) for v in vals]:
                fail(f"{row['name']}: differs from Python integers on the recorded operands")
        bnd = k6a_bound(B, Wc, rows, W_shr)
        trips = f"no loop: {len(rows)} sum(s) of {len(terms)} terms"
    elif name == "compose_prologue":
        F1, F2, h, h2, Lh, Lxn = args
        fn = lambda: cgp.compose_prologue_cuda(F1, F2, h, h2, Lh, Lxn)  # noqa: E731
        plain = lambda: cgp.compose_prologue_plain(F1, F2, h, h2, Lh, Lxn)  # noqa: E731
        got = fn()
        bnd = k6b_bound(B, W, Lh, Lxn)
        trips = (f"no loop: {int((got[12] | got[13]).sum())} identity lanes"
                 + (f", {int(got[14].sum())} narrow lanes" if len(got) > 14 else ""))
    elif name == "gcd_bridge":
        fn = lambda: cgp.gcd_bridge_cuda(*args)  # noqa: E731
        plain = lambda: cgp.gcd_bridge_plain(*args)  # noqa: E731
        got = fn()
        nar = args[5]
        n_nar = 0 if nar is None else int(nar[2].sum())
        bnd = k6c_bound(B, W, 0 if nar is None else nar[0].shape[1], args[4], n_nar)
        trips = (f"no loop: {n_nar} narrow lanes, {int(got[2].sum())} fits8, "
                 f"{int(got[3].sum())} rare")
    elif name == "gcd2_merge":
        fn = lambda: cgp.gcd2_merge_cuda(*args)  # noqa: E731
        plain = lambda: cgp.gcd2_merge_plain(*args)  # noqa: E731
        got = fn()
        bnd = k6d_bound(B, args[0].shape[1], W, int(args[4].sum()))
        trips = f"no loop: {int(args[4].sum())} fits8 lanes"
    else:
        a3, csum = args
        fn = lambda: cgp.c3_operands_cuda(a3, csum)  # noqa: E731
        plain = lambda: cgp.c3_operands_plain(a3, csum)  # noqa: E731
        got = fn()
        n = min(B, 256)
        vals, cs = lb.limbs_to_ints(a3[:n].cpu()), lb.limbs_to_ints(csum[:n].cpu())
        es = [(v & -v).bit_length() - 1 if v else 16 * a3.shape[1] for v in vals]
        if lb.limbs_to_ints(got[0][:n].cpu()) != [c >> min(e, 16 * W - 1)
                                                  for c, e in zip(cs, es)] \
                or lb.limbs_to_ints(got[1][:n].cpu()) != [(v >> e) % (1 << (16 * W))
                                                          for v, e in zip(vals, es)]:
            fail(f"{row['name']}: differs from Python integers on the recorded operands")
        bnd = k6e_bound(B, a3.shape[1], W)
        trips = f"no loop: v2(a3) {_stats(torch.tensor(es))} on the first {n} lanes"
    row["max_abs_err"] = max_abs_diff(torch, _flat(got), _flat(plain()))
    plain_ms = timed(torch, plain, 1, warm=False)
    return timed(torch, fn, TIMING_REPS), plain_ms, bnd, trips


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


class LehmerCount:
    """Records each lane's working groups of the NUCOMP tail's Lehmer walk
    (cuda_group.lehmer_euclid: K7 on the card) inside a with block
    (groups: one (B,) tensor a call). A graph replay calls no dispatcher:
    only eager calls are counted."""

    def __enter__(self):
        from cofhe_tpu_torch.ops import cuda_group

        self.mod, self.orig, self.groups = cuda_group, cuda_group.lehmer_euclid, []

        def counted(*args, **kw):
            import torch

            it = torch.zeros(args[0].shape[0], dtype=torch.int32, device=args[0].device)
            out = self.orig(*args, iters=it, **kw)
            self.groups.append(it)
            return out

        cuda_group.lehmer_euclid = counted
        return self

    def __exit__(self, *exc):
        self.mod.lehmer_euclid = self.orig
        return False


def section_lines(f2m):
    """(first line, [(line, section) where each section after the prologue
    starts]) of forms2.CG.compose2_unreduced, by SECTION_MARKS."""
    import inspect

    src, start = inspect.getsourcelines(f2m.CG.compose2_unreduced)
    cuts = []
    for name, mark in SECTION_MARKS:
        i = next(i for i, ln in enumerate(src) if ln.strip().startswith(mark))
        cuts.append((start + i, name))
    return start, cuts


def compose_sections(torch, cg, b1, b2, kernel_names) -> dict:
    """Device ms of one eager compose2's torch ops (not the kernels named)
    by section of forms2.CG.compose2_unreduced (SECTION_MARKS) and of
    compose2_eager (its identity selects, the reduction's operands or the
    NUCOMP tail). A line tracer opens a profiler range as each section
    starts, and each device kernel counts for the range around the torch
    op that launched it."""
    import inspect

    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    f2m = sys.modules[type(cg).__module__]
    _, cuts = section_lines(f2m)
    unreduced, eager = f2m.CG.compose2_unreduced.__code__, f2m.CG.compose2_eager.__code__
    src, start = inspect.getsourcelines(f2m.CG.compose2_eager)
    eager_sec = {start + i: ("identity selects" if "bform_select" in ln else
                             "NUCOMP tail" if "_nucomp_tail" in ln else "reduction operands")
                 for i, ln in enumerate(src)}
    state = {"range": None, "sec": None}

    def enter(sec):
        if sec != state["sec"]:
            if state["range"] is not None:
                state["range"].__exit__(None, None, None)
            state["range"], state["sec"] = record_function(f"compose2 section: {sec}"), sec
            state["range"].__enter__()

    def tracer(frame, event, arg):
        if frame.f_code is unreduced:
            if event == "line":
                enter(next((name for line, name in reversed(cuts) if frame.f_lineno >= line),
                           "prologue"))
            return tracer
        if frame.f_code is eager:
            if event == "line" and frame.f_lineno in eager_sec:
                enter(eager_sec[frame.f_lineno])
            return tracer
        return None

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sys.settrace(tracer)
        try:
            cg.compose2_eager(b1, b2)
        finally:
            sys.settrace(None)
            if state["range"] is not None:
                state["range"].__exit__(None, None, None)
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels
                 if not any(n in k.name for n in kernel_names))
        if not us:
            continue
        sec, up = "unattributed", e
        while up is not None:
            if up.name.startswith("compose2 section: "):
                sec = up.name[len("compose2 section: "):]
                break
            up = up.cpu_parent
        split[sec] = split.get(sec, 0.0) + us / 1e3
    return split


def profile_compose(torch, cg, gmp, hsm, bform_from_forms, rng, label, B=128,
                    groups=None, sections=False):
    """Host wall time and device time of one compose2 at the decrypt
    ladder's batch (the device's busy share of a step), its span on the
    card's clock between CUDA events recorded before and after it, the
    device time split into the thirteen kernels and everything else, and with
    the NUCOMP tail the Lehmer walk's groups a lane (a replay calls no
    dispatcher: there `groups`, an eager call's on the same forms). A graph
    replay is profiled as it runs: copies in, one replay, clones out. With
    `sections`, "other" split by section of compose2 (compose_sections,
    one more eager call: the same torch ops a replay runs). Returns the
    groups a lane, if counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cofhe_tpu_torch.ops.cuda_group import KERNELS

    base = gmp.nupow_batch([hsm.h] * 16, [rng.getrandbits(1100) for _ in range(16)])
    b1 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
    b2 = bform_from_forms([base[rng.randrange(16)] for _ in range(B)], cg.L, "cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        cg.compose2(b1, b2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        cg.compose2(b1, b2)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        span_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cg.compose2(b1, b2)
            torch.cuda.synchronize()
        with LehmerCount() as lehmer:
            cg.compose2(b1, b2)
    # device-side events only: a CPU op's device time repeats its kernels'
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    split = dict.fromkeys(KERNELS + ("other",), 0.0)
    for e in device:
        k = "lehmer_euclid" if any(n in e.name for n in K7_DEVICE) else next(
            (n for n in split if n + "_kernel" in e.name), "other")
        split[k] += e.self_device_time_total / 1e3
    dev_ms = sum(split.values())
    busy = f"{dev_ms / wall_ms:.1%} of the wall time" if dev_ms else "not measured"
    if lehmer.groups:
        groups = lehmer.groups[0]
        note = f", Lehmer groups a lane {_stats(groups)}"
    else:
        note = (f", Lehmer groups a lane {_stats(groups)} (the eager call's)"
                if groups is not None and split["lehmer_euclid"] else "")
    log(f"compose2 B={B} ({label}): wall {wall_ms:.2f} ms, span on the card's clock "
        f"{span_ms:.2f} ms, device {dev_ms:.2f} ms ({busy}), {len(device)} device "
        f"kernels and copies{note}; device ms by kernel "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))
    if sections:
        with torch.inference_mode():
            sec = compose_sections(torch, cg, b1, b2, [n + "_kernel" for n in split
                                                       if n != "other"] + list(K7_DEVICE))
        total = sum(sec.values())
        log(f"compose2 B={B} ({label}): other device ms by section of compose2 "
            + (json.dumps({k: round(v, 4) for k, v in sorted(sec.items(),
                                                              key=lambda x: -x[1])})
               + f", {total:.3f} ms in all" if total else "not measured (no stacks)"))
    return groups


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
    from cofhe_tpu_torch.core import liss
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops import cuda_group, forms2, hostgmp, limb
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
    from cofhe_tpu_torch.tensor import Tensor

    return SimpleNamespace(
        CryptoSystem=CryptoSystem, CLHSM2k=CLHSM2k, liss=liss, cgp=cuda_group, f2m=forms2,
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
        for (kname, args), p in sorted(ptxas_instances(cgp.BUILD_INFO["log"]).items()):
            shapes = [f"{sh}" for sh, n in compose2_npt().items()
                      if n == (kname, args[0] if args else None)]
            log(f"ptxas {kname}_kernel<{', '.join(map(str, args))}>"
                + (f" (compose2: {', '.join(shapes)})" if shapes else "")
                + f": {p.get('regs')} registers, {p.get('stack')} bytes stack frame, "
                f"{p.get('stores')} / {p.get('loads')} bytes spill stores / loads")
    else:
        log("ptxas: libraries were already built, no compiler report")


def compose2_npt() -> dict:
    """{shape: (kernel, NPT)} of the K5m, K5d, K4, KT, K7 and K6a-K6e
    calls compose2 makes (NPT None: a kernel with no NPT template): K5m (La, Lb, L_out) and K5d (Lx, Ly, L_out) at ceil(L_out / 32),
    K4 (Lx, Ld) at ceil(N / 32), N = max(Lx, steps + Ld) + 1, KT and K7
    (the NUCOMP tail's) at ceil(L / 32)."""
    out = {sh: ("mag_mul", -(-sh[2] // 32)) for sh in K5M_SHAPES}
    out.update({sh: ("divexact_odd", -(-sh[2] // 32)) for sh in K5D_SHAPES})
    out.update({sh: ("redc_mod", -(-(max(sh[0], K4_STEPS + sh[1]) + 1) // 32))
                for sh in K4_SHAPES})
    out[(KT_L,)] = ("reduce_exact", -(-KT_L // 32))
    # K7's two kernels at the NUCOMP tail's width L
    out[("NUCOMP walk", KT_L)] = ("lehmer_euclid_walk", -(-KT_L // 32))
    out[("NUCOMP finish", KT_L)] = ("lehmer_euclid_finish", -(-KT_L // 32))
    # K6a's sums at L (xi's numerator, 2 m2, b3) and Lm (csum); K6b at L
    out[("K6a at L", KT_L)] = ("canon_sm", -(-KT_L // 32))
    out[("K6a csum", K5M_SHAPES[-1][2])] = ("canon_sm", -(-K5M_SHAPES[-1][2] // 32))
    out[("K6b", KT_L)] = ("compose_prologue", -(-KT_L // 32))
    out[("K6c", KT_L)] = ("gcd_bridge", -(-KT_L // 32))
    out[("K6d",)] = ("gcd2_merge", None)
    out[("K6e",)] = ("c3_operands", None)
    return out


def kernel_instance(mangled: str):
    """(kernel, template arguments) of a K5m, K5d, K4, KT, K7 or K6a-K6e
    instance's mangled name (K6d: no template), else None."""
    m = re.search(r"(mag_mul|divexact_odd|redc_mod|reduce_exact|lehmer_euclid_walk|"
                  r"lehmer_euclid_finish|canon_sm|compose_prologue|gcd_bridge|gcd2_merge|"
                  r"c3_operands)_kernel(?:I((?:Li\d+E)+)E)?", mangled)
    if not m:
        return None
    return m.group(1), tuple(int(v) for v in re.findall(r"Li(\d+)E", m.group(2) or ""))


def ptxas_instances(text: str) -> dict:
    """{(kernel, template arguments): {regs, stack, stores, loads}} of K5m's,
    K5d's, K4's, KT's, K7's and K6a's-K6e's instances in nvcc's -Xptxas=-v
    report."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?$",
                      ln.strip())
        if m:
            cur = kernel_instance(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(zip(("stack", "stores", "loads"),
                                               map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["regs"] = int(m.group(1))
    return out


def sass_functions(nvcc: str, lib: str) -> dict:
    """{mangled function name: its SASS} of a built library, from the
    toolkit's cuobjdump -sass."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def sass_counts(body: str) -> dict:
    """Tensor-core products, warp collectives, shared atomics and block
    barriers in one function's SASS, by mnemonic."""
    return {op: len(re.findall(rf"\b{op}U?\.", body)) for op in SASS_OPS}


def check_spills(cgp) -> None:
    """Every K7 and K6a-K6e instance in the build's ptxas report must spill
    nothing."""
    k6 = k6_kernels(cgp)
    inst = {k: p for k, p in ptxas_instances(cgp.BUILD_INFO["log"]).items()
            if k[0].startswith("lehmer_euclid") or k[0] in k6}
    if not inst:
        log("ptxas: no K7 or K6a-K6e instance in the report (libraries already built)")
        return
    missing = [n for n in k6 if not any(k[0] == n for k in inst)]
    if missing:
        fail(f"ptxas: no instance of {missing} in the build's report")
    bad = [f"{k[0]}<{', '.join(map(str, k[1]))}>" for k, p in sorted(inst.items())
           if p.get("stores") or p.get("loads")]
    if bad:
        fail(f"K7 / K6a-K6e instances spill: {bad}")
    for (kname, args), p in sorted(inst.items()):
        if kname in k6:
            log(f"ptxas {kname}_kernel<{', '.join(map(str, args))}>: {p.get('regs')} "
                f"registers, no spill")
    log(f"ptxas: none of the {len(inst)} K7 and K6a-K6e instances spills")


def check_sass(cgp) -> None:
    """Reads the SASS of the built K5m and KT libraries: every K5m instance
    must run its products as IMMA (the tensor cores); prints each
    instance's counts."""
    out = {}
    for name in ("mag_mul", "reduce_exact"):
        funcs = sass_functions(cgp._nvcc(), cgp._lib_path(name))
        for fn, body in funcs.items():
            inst = kernel_instance(fn)
            if inst is not None:
                out[inst] = sass_counts(body)
    k5m = {k: v for k, v in out.items() if k[0] == "mag_mul"}
    if not k5m:
        fail("no mag_mul_kernel instance in the SASS of the K5m library")
    for (kname, args), cnt in sorted(out.items()):
        if kname == "mag_mul" and cnt["IMMA"] == 0:
            fail(f"K5m instance mag_mul_kernel<{args}> has no IMMA instruction")
        log(f"sass {kname}_kernel<{', '.join(map(str, args))}>: "
            + ", ".join(f"{op} {n}" for op, n in cnt.items()))
    log(f"sass: all {len(k5m)} mag_mul_kernel instances run their products as IMMA")


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    os.environ.update(NODE_ENV)  # read when the node modules are imported
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
    from cofhe_tpu_torch.tools.kernel_compare import PhaseLib

    k7_clock = PhaseLib(cgp, cgp.CSRC_DIR, os.path.join(cgp.BUILD_DIR, "k7_phases",
                                                        "liblehmer_euclid_phases.so"))
    cgp.build()
    k7_clock.finish(fail)
    report_build(cgp)
    check_spills(cgp)
    check_sass(cgp)

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
    kt = {B: check_kt(torch, cgp, cg, gmp, hsm, port, rng, B)
          for B in (KERNEL_B, RAGGED_B, SMALL_B)}
    limb_k = check_limb_kernels(torch, cgp, lb, rng)
    ncg = f2m.CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    k7 = {B: check_k7(torch, cgp, ncg, lb, gmp, hsm, bform_from_forms, rng, B, k7_clock)
          for B in (KERNEL_B, RAGGED_B, SMALL_B)}
    own = random.Random(SEED + 13)  # K6a-K6e's own: rng reaches what follows as before
    k6a = {B: check_k6a(torch, cgp, lb, own, B) for B in TABLE_B}
    k6b = {B: check_k6b(torch, cgp, lb, cg, gmp, hsm, port, own, B) for B in TABLE_B}
    k6c = {B: check_k6c(torch, cgp, lb, own, cg, B) for B in TABLE_B}
    k6d = {B: check_k6d(torch, cgp, lb, own, cg, B) for B in TABLE_B}
    k6e = {B: check_k6e(torch, cgp, lb, own, cg, B) for B in TABLE_B}
    log(f"kernel checks: {time.perf_counter() - t:.1f} s")

    from cofhe_tpu_torch.ops import graphs
    from cofhe_tpu_torch.tools import mesh_check

    global CALLS
    CALLS = mesh_check.count_calls(cgp, graphs)
    rec = Recorder(torch, cgp)
    launches, main_by_key, main_path = run_slice(torch, cgp, rec, port.CryptoSystem,
                                                 port.Tensor, hostgmp.GmpEngine, rng)
    t = time.perf_counter()
    compare_decrypt(torch, cgp, port, rec, main_path)
    log(f"graph against eager decrypt phase: {time.perf_counter() - t:.1f} s")
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
    by_path = {"main": launches}
    by_path["engine_ops"], ops = run_engine_ops(torch, cgp, port, main_path, rng)
    log(f"engine-ops phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_path["network"] = run_network(torch, cgp, port, rng)
    log(f"network phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_path["mesh"] = run_mesh(torch, cgp, port, main_path, ops)
    log(f"mesh phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_path["legacy"], legacy_by_key, legacy_rec, ncg = run_legacy(torch, cgp, port,
                                                                   main_path, rng)
    log(f"legacy phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    reset_counts(cgp)
    _, nucomp_rec = compare_nucomp(torch, cgp, port, main_path, ncg, rng)
    nucomp_by_key = dict(cgp.LAUNCHES_BY_KEY)
    log(f"NUCOMP against default phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    table = []
    with torch.inference_mode():
        for key in sorted(rec.ops, key=lambda k: (k[3], k[0], k[1])):
            table.append(table_row(torch, cgp, f2m, cg, lb, key, rec.ops[key],
                                   main_by_key.get(key, 0)))
        # the legacy path's shapes that the main path has not (K3, KT at Ln;
        # K7), and K7 at the NUCOMP comparison's batches
        for key in sorted(k for k in legacy_rec.ops if k not in rec.ops):
            table.append(table_row(torch, cgp, f2m, cg, lb, key, legacy_rec.ops[key],
                                   legacy_by_key[key]))
        for key in sorted(k for k in nucomp_rec.ops if k not in legacy_rec.ops):
            table.append(table_row(torch, cgp, f2m, cg, lb, key, nucomp_rec.ops[key],
                                   nucomp_by_key.get(key, 0)))
    log(f"kernel table: {time.perf_counter() - t:.1f} s, {len(table)} rows")
    for want in TABLE_B:
        if not any(r["name"].endswith(f"@B={want}") for r in table):
            fail(f"no main-path operands were recorded at batch {want}")

    def entry(name, route_src, replaces, r):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name] for k, p in by_path.items()},
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                **({"bound_cuda_cores_ms": r["bound_cuda_cores_ms"]}
                   if "bound_cuda_cores_ms" in r else {}),
                "library_ms": None}

    src = {"xgcd_coeff_g": ("cofhe_tpu_torch/csrc/xgcd_coeff_g.cu",
                            "cofhe_tpu/ops/pallas_group.py:144"),
           "mod_topdown": ("cofhe_tpu_torch/csrc/mod_topdown.cu",
                           "cofhe_tpu/ops/pallas_group.py:103"),
           "reduce2_grouped": ("cofhe_tpu_torch/csrc/reduce2_grouped.cu",
                               "cofhe_tpu/ops/forms2.py:233"),
           "reduce_exact": ("cofhe_tpu_torch/csrc/reduce_exact.cu",
                            "cofhe_tpu/ops/forms.py:207"),
           "mag_mul": ("cofhe_tpu_torch/csrc/mag_mul.cu", "cofhe_tpu/ops/limb.py:352"),
           "divexact_odd": ("cofhe_tpu_torch/csrc/divexact_odd.cu",
                            "cofhe_tpu/ops/limb.py:566"),
           "redc_mod": ("cofhe_tpu_torch/csrc/redc_mod.cu", "cofhe_tpu/ops/rl.py:486"),
           "lehmer_euclid": ("cofhe_tpu_torch/csrc/lehmer_euclid.cu",
                             "cofhe_tpu/ops/rl.py:347"),
           "canon_sm": ("cofhe_tpu_torch/csrc/canon_sm.cu", "cofhe_tpu/ops/limb.py:113"),
           "compose_prologue": ("cofhe_tpu_torch/csrc/compose_prologue.cu",
                                "cofhe_tpu/ops/forms2.py:478"),
           "gcd_bridge": ("cofhe_tpu_torch/csrc/gcd_bridge.cu", "cofhe_tpu/ops/forms2.py:536"),
           "gcd2_merge": ("cofhe_tpu_torch/csrc/gcd2_merge.cu", "cofhe_tpu/ops/forms2.py:588"),
           "c3_operands": ("cofhe_tpu_torch/csrc/c3_operands.cu",
                           "cofhe_tpu/ops/forms2.py:638")}
    kernels = [
        entry("xgcd_coeff_g", *src["xgcd_coeff_g"], k1[(88, False, KERNEL_B)]),
        entry("mod_topdown", *src["mod_topdown"], k2[KERNEL_B]),
        entry("reduce2_grouped", *src["reduce2_grouped"], k3[KERNEL_B]),
        entry("reduce_exact", *src["reduce_exact"], kt[KERNEL_B]),
        # the 16384-lane ladder's a3 / t / t2 product, m2 quotient and
        # width-72 REDC (every shape has its own table row below)
        entry("mag_mul", *src["mag_mul"], limb_k["mag_mul"][((72, 144, 144), KERNEL_B)]),
        entry("divexact_odd", *src["divexact_odd"],
              limb_k["divexact_odd"][((144, 72, 144), KERNEL_B)]),
        entry("redc_mod", *src["redc_mod"], limb_k["redc_mod"][((72, 72), KERNEL_B)]),
        # the walk operands of 16384 compose2 pairs (the NUCOMP tail's)
        entry("lehmer_euclid", *src["lehmer_euclid"], k7[KERNEL_B]),
        # two-term sums at L on 16384 lanes; the prologue on 16384 compose2
        # pairs (every recorded call has its own table row below)
        entry("canon_sm", *src["canon_sm"], k6a[KERNEL_B][KT_L]),
        entry("compose_prologue", *src["compose_prologue"], k6b[KERNEL_B]),
        # the gcd bridge, merge and c3's operands at compose2's widths on
        # 16384 synthetic lanes (the recorded calls have their rows below)
        entry("gcd_bridge", *src["gcd_bridge"], k6c[KERNEL_B]),
        entry("gcd2_merge", *src["gcd2_merge"], k6d[KERNEL_B]),
        entry("c3_operands", *src["c3_operands"], k6e[KERNEL_B]),
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
