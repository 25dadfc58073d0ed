"""The kernels of this checkout against those built from an earlier csrc/
directory, on the operands the main path really passes, on one CUDA card.

    python3 -m cofhe_tpu_torch.tools.kernel_compare --baseline-csrc DIR

DIR holds the earlier sources of the three kernels (and warp_limbs.cuh)
with this checkout's C entry points (cuda_group._ARGTYPES); for example an
unpacked `git archive <commit> cofhe_tpu_torch/csrc`. The earlier K1 is
the 13-divstep kernel: it gets its loop cap in 13-step groups (a cap that
also covers any kernel of longer groups, whose loop ends once g is zero),
and its trips count 13 divsteps a group. Where an earlier kernel is the
same source as this checkout's, its pair of times shows the spread of the
measurement. From the root of a checkout, the script:

1. builds this checkout's kernels and the earlier ones side by side;
2. drives chip_smoke's main path once (its checks included), recording
   the operands of one decrypt, chain and ladder compose2;
3. runs the main path's matmul twice more in the same process on the same
   inputs and Enc(0), with this checkout's kernels and with the earlier
   ones: seconds, exact-tail iterations, and whether the outputs equal the
   main run's;
4. on each recorded operand, checks that both kernels agree (K1 and K2
   bit for bit, K3 after the exact tail) and times them in turns
   (earlier, this, this, earlier), with each one's trips and bound (the
   earlier K1's at its 13-divstep per-limb count, K2 and K3 at this
   checkout's counts);
5. profiles one compose2 at 128 lanes with each set of kernels.

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
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE_K1_STEPS = 13  # divsteps a group of the earlier K1


class Baseline:
    """The kernels of another csrc/ directory, built with the package's
    nvcc flags and called on the same tensors through this checkout's C
    entry points."""

    def __init__(self, csrc: str, cgp, fail):
        self.csrc, self.cgp, self.fail, self.fns, self.procs = csrc, cgp, fail, {}, {}
        self.out_dir = os.path.join(cgp.BUILD_DIR, "baseline")

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        for name in self.cgp.KERNELS:
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


# cuda_group's wrapper for each kernel
WRAPPER = {"xgcd_coeff_g": "xgcd_coeff_g_cuda", "mod_topdown": "mod_topdown_cuda",
           "reduce2_grouped": "reduce2_grouped_loop_cuda"}


@contextlib.contextmanager
def baseline_in_place(torch, cgp, base):
    """cuda_group's kernel wrappers replaced by the baseline's."""
    saved = {n: getattr(cgp, WRAPPER[n]) for n in cgp.KERNELS}
    for n in cgp.KERNELS:
        setattr(cgp, WRAPPER[n], lambda *a, _n=n, **k: getattr(base, _n)(torch, *a, **k))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cgp, WRAPPER[n], fn)


def matmul_again(torch, smoke, cgp, base, slice_args) -> None:
    """The main path's matmul once more with this checkout's kernels and
    once with the baseline's, on the same inputs and Enc(0)."""
    from cofhe_tpu_torch.core.qfi import is_reduced, reduce_form

    cs, pk, pt, ct, res, rand_at_matmul = slice_args
    for label in ("this checkout's kernels", "the baseline kernels"):
        cs.rand_gen = copy.deepcopy(rand_at_matmul)  # the same Enc(0)
        swap = baseline_in_place(torch, cgp, base) if label.startswith("the baseline") \
            else contextlib.nullcontext()
        with swap:
            t = time.perf_counter()
            with smoke.TailCount() as tail:
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
        smoke.log(f"matmul again with {label}: {secs:.3f} s, {tail.n} exact-tail "
                  f"iterations, phases " + json.dumps(
                      {k: round(v, 3) for k, v in cs._engine.last_matmul_phases.items()})
                  + f"; {len(differ)} of {2 * len(res.data)} output forms differ from "
                  f"the main run's, {unreduced} of them not reduced, {other_class} "
                  f"of another class")
        if differ:
            smoke.fail(f"the matmul again with {label} gave other ciphertexts")


def compare_row(torch, smoke, cgp, cg, base, key, args) -> None:
    """This checkout's kernel and the baseline one on one recorded operand:
    agreement, trips, times in turns and bounds (each over its own trips
    and limbs)."""
    name, W, _, B = key
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
    else:
        a, b, c, dD_mant, dD_top, red_iters = args
        got = cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters,
                                            iters=it_new)
        old = base.reduce2_grouped(torch, a, b, c, dD_mant, dD_top, red_iters,
                                   iters=it_old)
        with smoke.TailCount() as t_new:
            tail_new = cg._tail(*got)
        with smoke.TailCount() as t_old:
            tail_old = cg._tail(*old)
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
        tails = f", exact-tail iterations {t_new.n} (baseline {t_old.n})"
    # a first timing warms the card and sizes each turn to >= 20 ms of calls
    reps = max(smoke.TIMING_REPS, int(20.0 / smoke.timed(torch, new_fn, 3)))
    t = {"new": [], "old": []}
    for turn, fn in (("old", old_fn), ("new", new_fn), ("new", new_fn), ("old", old_fn)):
        t[turn].append(smoke.timed(torch, fn, reps))
    ms, old_ms = sum(t["new"]) / 2, sum(t["old"]) / 2
    bms, old_bms = smoke.bound(new_ops, nbytes)[0], smoke.bound(old_ops, nbytes)[0]
    smoke.log(f"compare {name}[W={W}]@B={B}: this kernel {ms:.4f} ms (trips "
              f"{trips_new}, bound {bms:.5f} ms, {bms / ms:.1%} of it), "
              f"baseline {old_ms:.4f} ms (trips {trips_old}, bound "
              f"{old_bms:.5f} ms, {old_bms / old_ms:.1%} of it), {old_ms / ms:.2f}x; "
              f"turns {t['old'][0]:.4f} {t['new'][0]:.4f} {t['new'][1]:.4f} "
              f"{t['old'][1]:.4f} ms, {reps} calls each" + tails)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", required=True,
                    help="a csrc/ directory with the earlier kernel sources")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, _ROOT)
    import chip_smoke as smoke

    port = smoke.import_port()
    if port is None:
        return 1
    cgp = port.cgp
    smi = smoke.card_line()
    smoke.log(smi)
    if port.hostgmp.get_lib() is None:
        smoke.fail("the GMP host backend (g++ + libgmp) did not build")
    base = Baseline(opts.baseline_csrc, cgp, smoke.fail)
    base.start()
    cgp.build()
    base.finish()
    smoke.report_build(cgp)
    smoke.log(f"baseline kernels built from {opts.baseline_csrc}")

    rng = random.Random(smoke.SEED)
    hsm = port.CLHSM2k(smoke.SEC, smoke.K)
    cg = port.TorchEngine(hsm, "cuda").cg
    gmp = port.hostgmp.GmpClassGroup(hsm.Delta)
    rec = smoke.Recorder(torch, cgp)
    _, slice_args = smoke.run_slice(torch, cgp, rec, port.CryptoSystem, port.Tensor,
                                    port.hostgmp.GmpEngine, rng)
    matmul_again(torch, smoke, cgp, base, slice_args)
    with torch.inference_mode():
        for key in sorted(rec.ops, key=lambda k: (k[3], k[0], k[1])):
            compare_row(torch, smoke, cgp, cg, base, key, rec.ops[key])
    smoke.profile_compose(torch, cg, gmp, hsm, port.bform_from_forms, rng,
                          "this checkout's kernels")
    with baseline_in_place(torch, cgp, base):
        smoke.profile_compose(torch, cg, gmp, hsm, port.bform_from_forms, rng,
                              "baseline kernels")
    smoke.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
