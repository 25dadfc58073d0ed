#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (cofhe_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds the Hopper kernels from cofhe_tpu_torch/csrc with nvcc and holds
   each one against its plain torch version on the card, at the shapes the
   main path gives it (bit-exact, and against Python integers), timing both.
2. Drives the main path once at sec=128, k=128 through the facade:
   keygen, encrypt_tensor ct(2x64), scal_ciphertext_tensors with pt(64x64)
   (16384 ladder lanes), decrypt_tensor; every plaintext must equal the
   integer matmul mod 2^128, the kernels' launch counters must have grown,
   and two output ciphertexts must be bit-identical to the GMP host
   backend's for the same inputs and Enc(0).
3. Prints the card's name and power limit, one JSON line with each kernel's
   numbers, and as the last line {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. It needs CUDA and
the rest of the repository; without either it exits non-zero and prints no
result.
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
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the int32 rate as half
# the FP32 lanes of the 67 TFLOP/s float32 figure, one op per lane per clock
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
# int32 operations per limb of one loop iteration, counted from the kernel
# sources (products, sums, shifts, masks; a carry pass counts 5, a value
# estimate 4): K1 per divstep group (+84 with need_u), K2 per iteration,
# K3 per group
OPS_K1, OPS_K1_U, OPS_K2, OPS_K3 = 108, 84, 20, 74


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(ops: float, nbytes: float):
    t_ops, t_mem = ops / INT32_OPS_PER_S, nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def timed(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call over `reps` calls (after one warm-up call unless the
    caller has just run `fn`), timed with CUDA events."""
    if warm:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(torch, xs, ys) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(xs, ys))


# ------------------------------------------------------------ kernel checks


def check_k1(torch, cgp, lb, rng, W, nbits, need_u, B, op_bits):
    """K1 vs its plain version and Python's gcd / Bezout identity."""
    dev = "cuda"
    fs = [rng.getrandbits(rng.randrange(op_bits // 2, op_bits + 1)) | 1
          for _ in range(B)]
    gs = [rng.getrandbits(rng.randrange(1, op_bits + 1)) for _ in range(B)]
    k = rng.getrandbits(op_bits // 3) | 1
    edge = [(1, 0), (1, 5), (3, 0), (3, 6), (k * 9, k * 6),
            ((1 << (op_bits - 1)) + 1, 2), (fs[0], fs[0]), (fs[1], 0)]
    for i, (f, g) in enumerate(edge):
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
    d, cg = lb.limbs_to_ints(got[0]), lb.limbs_to_ints(got[1])
    cu = lb.limbs_to_ints(got[2]) if need_u else None
    for i in range(B):
        if d[i] != math.gcd(fs[i], gs[i]) or not 0 <= cg[i] < fs[i] \
                or (cg[i] * gs[i] - d[i]) % fs[i]:
            fail(f"K1 W={W} lane {i}: gcd/Bezout wrong")
        if need_u and (cu[i] * fs[i] + cg[i] * gs[i] - d[i]) % fs[i]:
            fail(f"K1 W={W} lane {i}: need_u Bezout wrong")
    ms = timed(torch, lambda: cgp.xgcd_coeff_g_cuda(f, g, f, nbits, need_u), 5)
    plain_ms = timed(torch, lambda: cgp.xgcd_coeff_g_plain(f, g, f, nbits, need_u),
                     1, warm=False) if B == KERNEL_B else float("nan")
    per_limb = OPS_K1 + (OPS_K1_U if need_u else 0)
    ops = float(iters.long().sum()) * W * per_limb
    nbytes = 4.0 * B * W * (3 + (3 if need_u else 2))
    bms, by = bound(ops, nbytes)
    log(f"K1 xgcd_coeff_g W={W} nbits={nbits} need_u={need_u} B={B}: "
        f"bit-exact, oracle ok; groups mean {float(iters.float().mean()):.1f} "
        f"max {int(iters.max())}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


def check_k2(torch, cgp, lb, rng, B):
    """K2 on the mu reduction's shapes: x (B, 264) signed, m (B, 144) even."""
    dev = "cuda"
    Lx, Lm, max_iters = 264, 144, 378
    xs = [rng.getrandbits(rng.randrange(2000, 4150)) * rng.choice((1, -1))
          for _ in range(B)]
    ms_ = [rng.getrandbits(rng.randrange(1000, 2080)) * 2 + 2 for _ in range(B)]
    edge = [(0, 2), (-1, 2), ((1 << 630) - 1, 3), (ms_[3], ms_[3]),
            (-ms_[4], ms_[4]), ((1 << 4150) - 1, 2), (ms_[6] - 1, ms_[6])]
    for i, (x, m) in enumerate(edge):
        xs[i], ms_[i] = x, m
    sx, mx = lb.ints_to_signed(xs, Lx)
    x = (torch.as_tensor(sx)[:, None] * torch.as_tensor(mx)).to(dev)
    m = torch.as_tensor(lb.ints_to_limbs(ms_, Lm)).to(dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    got = cgp.mod_topdown_cuda(x, m, max_iters, iters=iters)
    torch.cuda.synchronize()
    plain = cgp.mod_topdown_plain(x, m, max_iters)
    err = max_abs_diff(torch, [got], [plain])
    if err:
        fail(f"K2 B={B} differs from its plain version (max {err})")
    vals = lb.limbs_to_ints(got)
    for i in range(B):
        if vals[i] != xs[i] % ms_[i]:
            fail(f"K2 lane {i}: x mod m wrong")
    ms = timed(torch, lambda: cgp.mod_topdown_cuda(x, m, max_iters), 5)
    plain_ms = timed(torch, lambda: cgp.mod_topdown_plain(x, m, max_iters), 1,
                     warm=False) if B == KERNEL_B else float("nan")
    ops = float(iters.long().sum()) * Lx * OPS_K2
    bms, by = bound(ops, 4.0 * B * (2 * Lx + Lm))
    log(f"K2 mod_topdown Lx={Lx} Lm={Lm} B={B}: bit-exact, oracle ok; "
        f"iterations mean {float(iters.float().mean()):.1f} max {int(iters.max())}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


def check_k3(torch, cgp, cg, gmp, hsm, bform_from_forms, bform_to_forms, rng, B):
    """K3 on the unreduced compose outputs of B random form pairs: after the
    exact tail it must give the plain version's forms and GMP's composes."""
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
        got = cg._tail(*cgp.reduce2_grouped_loop_cuda(a3, bred, c3, *args,
                                                      iters=iters))
        plain = cg._tail(*cgp.reduce2_grouped_loop_plain(a3, bred, c3, *args))
        err = max_abs_diff(torch, got, plain)
        if err:
            fail(f"K3 B={B}: reduced forms differ from the plain version")
        want = gmp.compose_batch(f1[:256], f2[:256])
        if bform_to_forms(got)[:256] != want:
            fail(f"K3 B={B}: reduced forms differ from GMP's composes")
        ms = timed(torch, lambda: cgp.reduce2_grouped_loop_cuda(a3, bred, c3, *args), 5)
        plain_ms = timed(torch, lambda: cgp.reduce2_grouped_loop_plain(
            a3, bred, c3, *args), 1, warm=False) if B == KERNEL_B else float("nan")
    L = a3.shape[1]
    ops = float(iters.long().sum()) * L * OPS_K3
    bms, by = bound(ops, 4.0 * B * L * 6)
    log(f"K3 reduce2_grouped L={L} B={B}: tail-exact vs plain and GMP; groups "
        f"mean {float(iters.float().mean()):.1f} max {int(iters.max())}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, err=err)


def profile_compose(torch, cg, gmp, hsm, bform_from_forms, rng, B=128):
    """Host wall time and device time of one compose2 at the decrypt
    ladder's batch (the device's busy share of a host-driven step)."""
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
    # device-side events only: a CPU op's device time repeats its kernels'
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3
    kernels = len(device)
    busy = f"{dev_ms / wall_ms:.1%} of the wall time" if dev_ms else "not measured"
    log(f"compose2 B={B}: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms "
        f"({busy}), {kernels} device kernels and copies")


# ---------------------------------------------------------------- the path


def run_slice(torch, cgp, CryptoSystem, Tensor, GmpEngine, rng):
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
    t = time.perf_counter()
    ct = cs.encrypt_tensor(pk, Tensor(ctv, (N_ROWS, M_INNER)))
    torch.cuda.synchronize()
    phases["encrypt_s"] = time.perf_counter() - t
    # the facade draws the matmul's Enc(0) from its generator: a copy of the
    # generator replays it for the host check below
    rand_at_matmul = copy.deepcopy(cs.rand_gen)
    t = time.perf_counter()
    res = cs.scal_ciphertext_tensors(pk, pt, ct)
    torch.cuda.synchronize()
    phases["matmul_s"] = time.perf_counter() - t
    phases.update({f"matmul_{k}": v for k, v in cs._engine.last_matmul_phases.items()})
    t = time.perf_counter()
    dec = cs.decrypt_tensor(sk, res)
    torch.cuda.synchronize()
    phases["decrypt_s"] = time.perf_counter() - t
    launches = dict(cgp.LAUNCHES)

    for i in range(N_ROWS):
        for kk in range(P_COLS):
            want = sum(ctv[i * M_INNER + j] * sv[j * P_COLS + kk]
                       for j in range(M_INNER)) % M
            if dec.at(i, kk) != want:
                fail(f"decrypted ({i}, {kk}) != integer matmul mod 2^{K}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # bit-identity with the GMP host backend: ct row 0 x pt[:, :2] with the
    # same Enc(0) must give the main path's res[0, 0] and res[0, 1]
    t = time.perf_counter()
    zero = cs.hsm2k.encrypt(pk, 0, rand_at_matmul)
    row0 = Tensor([ct.at(0, j) for j in range(M_INNER)], (1, M_INNER))
    pt2 = Tensor([sv[j * P_COLS + kk] for j in range(M_INNER) for kk in range(2)],
                 (M_INNER, 2))
    host_out = GmpEngine(cs.hsm2k).scal_matmul(pt2, row0, zero)
    if list(host_out.data) != [res.at(0, 0), res.at(0, 1)]:
        fail("matmul ciphertexts differ from the GMP host backend's")
    phases["gmp_check_s"] = time.perf_counter() - t
    log(f"slice ct({N_ROWS}x{M_INNER}) x pt({M_INNER}x{P_COLS}) at sec={SEC} k={K}: "
        f"{N_ROWS * P_COLS} plaintexts correct, 2 ciphertexts bit-identical to GMP")
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    log("main-path launches: " + json.dumps(launches))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import cofhe_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the cofhe_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    if not os.path.abspath(cofhe_tpu_torch.__file__).startswith(here + os.sep):
        print("chip_smoke: cofhe_tpu_torch does not come from this checkout",
              file=sys.stderr)
        return 1
    from cofhe_tpu_torch.api import CryptoSystem
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops import cuda_group as cgp
    from cofhe_tpu_torch.ops import hostgmp, limb as lb
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
    from cofhe_tpu_torch.tensor import Tensor

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    if hostgmp.get_lib() is None:
        fail("the GMP host backend (g++ + libgmp) did not build")
    log("host backend: GMP (csrc/classgroup.cpp)")
    cgp.build()
    log(f"kernel build: {cgp.BUILD_INFO['seconds']:.1f} s for {list(cgp.KERNELS)}")
    lines = cgp.BUILD_INFO["log"].splitlines()
    spills = [ln.strip() for ln in lines if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines if "registers" in ln]
    if regs:
        log(f"ptxas: {len(regs)} kernel instances, registers {min(regs)}-"
            f"{max(regs)} a thread, {len(spills)} with spills"
            + "".join("\n  " + x for x in spills))
    else:
        log("ptxas: libraries were already built, no compiler report")

    rng = random.Random(SEED)
    t = time.perf_counter()
    k1 = {}
    for W, nbits, need_u, op_bits in ((88, 1392, False, 1100),
                                      (144, 2117, False, 2085),
                                      (144, 2117, True, 2085),
                                      (8, 136, False, 120)):
        for B in (KERNEL_B, RAGGED_B):
            k1[(W, need_u, B)] = check_k1(torch, cgp, lb, rng, W, nbits,
                                          need_u, B, op_bits)
    k2 = {B: check_k2(torch, cgp, lb, rng, B) for B in (KERNEL_B, RAGGED_B)}
    hsm = CLHSM2k(SEC, K)
    cg = TorchEngine(hsm, "cuda").cg
    gmp = hostgmp.GmpClassGroup(hsm.Delta)
    k3 = {B: check_k3(torch, cgp, cg, gmp, hsm, bform_from_forms,
                      bform_to_forms, rng, B) for B in (KERNEL_B, RAGGED_B)}
    log(f"kernel checks: {time.perf_counter() - t:.1f} s")

    launches = run_slice(torch, cgp, CryptoSystem, Tensor, hostgmp.GmpEngine, rng)
    profile_compose(torch, cg, gmp, hsm, bform_from_forms, rng)

    def entry(name, route_src, replaces, r):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    kernels = [
        entry("xgcd_coeff_g", "cofhe_tpu_torch/csrc/xgcd_coeff_g.cu",
              "cofhe_tpu/ops/pallas_group.py:144", k1[(88, False, KERNEL_B)]),
        entry("mod_topdown", "cofhe_tpu_torch/csrc/mod_topdown.cu",
              "cofhe_tpu/ops/pallas_group.py:103", k2[KERNEL_B]),
        entry("reduce2_grouped", "cofhe_tpu_torch/csrc/reduce2_grouped.cu",
              "cofhe_tpu/ops/forms2.py:233", k3[KERNEL_B]),
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
