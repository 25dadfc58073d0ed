"""K2 and K3 of this checkout against those of an earlier csrc/ directory,
on the operands the main path really passes, on one CUDA card.

    python3 -m cofhe_tpu_torch.tools.kernel_compare --baseline-csrc DIR
    python3 -m cofhe_tpu_torch.tools.kernel_compare --baseline-csrc DIR --k3-split

DIR holds the earlier mod_topdown.cu (24-bit digits over all of x) and
reduce2_grouped.cu (2^12 matrix budget), whose C entry points take dD_mant
as a float; for example an unpacked `git archive` of an earlier commit's
cofhe_tpu_torch/csrc. From the root of a checkout, the script:

1. builds this checkout's kernels and the earlier K2 and K3 side by side;
2. drives chip_smoke's main path once (its checks included), recording
   the operands of one decrypt, chain and ladder compose2;
3. runs the main path's matmul twice more in the same process on the same
   inputs and Enc(0), with this checkout's K2 and K3 and with the earlier
   ones: seconds, exact-tail iterations, and whether the outputs equal the
   main run's;
4. on each recorded K2 and K3 operand, checks that both kernels agree
   (K2 bit for bit, K3 after the exact tail) and times them in turns
   (earlier, this, this, earlier), with each one's trips and bound;
5. profiles one compose2 at 128 lanes with each pair of kernels;
6. with --k3-split, times K3 with its simulation cut and with its apply
   cut, for the full kernel's mean group count.

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


class Baseline:
    """The K2 and K3 kernels of another csrc/ directory (the earlier C entry
    points: dD_mant as a float), built with the package's nvcc flags and
    called on the same tensors."""

    ARGTYPES = {
        "mod_topdown": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "reduce2_grouped": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    }

    def __init__(self, csrc: str, cgp, fail):
        self.csrc, self.cgp, self.fail, self.fns, self.procs = csrc, cgp, fail, {}, {}
        self.out_dir = os.path.join(cgp.BUILD_DIR, "baseline")

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        for name in self.ARGTYPES:
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
            fn.restype, fn.argtypes = ctypes.c_int, self.ARGTYPES[name]
            self.fns[name] = fn

    def _call(self, torch, name, *args):
        rc = self.fns[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            self.fail(f"baseline {name} launch failed: cudaError {rc}")

    def mod_topdown(self, torch, x, m, max_iters, iters=None):
        out = torch.empty_like(x)
        self._call(torch, "mod_topdown", x.data_ptr(), m.data_ptr(),
                   out.data_ptr(), None if iters is None else iters.data_ptr(),
                   x.shape[0], x.shape[1], m.shape[1], int(max_iters))
        return out

    def reduce2(self, torch, a, b, c, dD_mant, dD_top, red_iters, iters=None):
        ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
        self._call(torch, "reduce2_grouped", a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), ao.data_ptr(), bo.data_ptr(), co.data_ptr(),
                   None if iters is None else iters.data_ptr(), a.shape[0],
                   a.shape[1], int(dD_top), int(red_iters), float(dD_mant))
        return ao, bo, co


@contextlib.contextmanager
def baseline_in_place(torch, cgp, base):
    """cuda_group's K2 and K3 wrappers replaced by the baseline kernels."""
    saved = cgp.mod_topdown_cuda, cgp.reduce2_grouped_loop_cuda
    cgp.mod_topdown_cuda = lambda x, m, mi, iters=None: \
        base.mod_topdown(torch, x, m, mi, iters)
    cgp.reduce2_grouped_loop_cuda = lambda a, b, c, dm, dt, ri, iters=None: \
        base.reduce2(torch, a, b, c, dm, dt, ri, iters)
    try:
        yield
    finally:
        cgp.mod_topdown_cuda, cgp.reduce2_grouped_loop_cuda = saved


def matmul_again(torch, smoke, cgp, base, slice_args) -> None:
    """The main path's matmul once more with this checkout's kernels and
    once with the baseline K2 and K3, on the same inputs and Enc(0)."""
    from cofhe_tpu_torch.core.qfi import is_reduced, reduce_form

    cs, pk, pt, ct, res, rand_at_matmul = slice_args
    for label in ("this checkout's K2 and K3", "the baseline K2 and K3"):
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
    agreement, trips, times in turns and bounds (each at its own per-limb
    count, over its own trips and limbs)."""
    name, W, _, B = key
    dev = args[0].device
    it_new = torch.zeros(B, dtype=torch.int32, device=dev)
    it_old = torch.zeros_like(it_new)
    if name == "mod_topdown":
        x, m, max_iters = args
        got = cgp.mod_topdown_cuda(x, m, max_iters, iters=it_new)
        old = base.mod_topdown(torch, x, m, max_iters, iters=it_old)
        if smoke.max_abs_diff(torch, [old], [got]):
            smoke.fail(f"{name}@B={B}: the baseline kernel disagrees")
        new_fn = lambda: cgp.mod_topdown_cuda(x, m, max_iters)  # noqa: E731
        old_fn = lambda: base.mod_topdown(torch, x, m, max_iters)  # noqa: E731
        new_ops = float(it_new.long().sum()) * smoke.k2_window(m.shape[1]) * smoke.OPS_K2
        old_ops = float(it_old.long().sum()) * W * smoke.OPS_K2_OLD
        nbytes = 4.0 * B * (2 * W + m.shape[1])
        tails = ""
    else:
        a, b, c, dD_mant, dD_top, red_iters = args
        got = cgp.reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters,
                                            iters=it_new)
        old = base.reduce2(torch, a, b, c, dD_mant, dD_top, red_iters, iters=it_old)
        with smoke.TailCount() as t_new:
            tail_new = cg._tail(*got)
        with smoke.TailCount() as t_old:
            tail_old = cg._tail(*old)
        if smoke.max_abs_diff(torch, tail_old, tail_new):
            smoke.fail(f"{name}@B={B}: the baseline kernel disagrees after the tail")
        new_fn = lambda: cgp.reduce2_grouped_loop_cuda(  # noqa: E731
            a, b, c, dD_mant, dD_top, red_iters)
        old_fn = lambda: base.reduce2(  # noqa: E731
            torch, a, b, c, dD_mant, dD_top, red_iters)
        new_ops = float(it_new.long().sum()) * W * smoke.OPS_K3
        old_ops = float(it_old.long().sum()) * W * smoke.OPS_K3_OLD
        nbytes = 4.0 * B * W * 6
        tails = f", exact-tail iterations {t_new.n} (baseline {t_old.n})"
    # a first timing warms the card and sizes each turn to >= 20 ms of calls
    reps = max(smoke.TIMING_REPS, int(20.0 / smoke.timed(torch, new_fn, 3)))
    t = {"new": [], "old": []}
    for turn, fn in (("old", old_fn), ("new", new_fn), ("new", new_fn), ("old", old_fn)):
        t[turn].append(smoke.timed(torch, fn, reps))
    ms, old_ms = sum(t["new"]) / 2, sum(t["old"]) / 2
    bms, old_bms = smoke.bound(new_ops, nbytes)[0], smoke.bound(old_ops, nbytes)[0]
    smoke.log(f"compare {name}@B={B}: this kernel {ms:.4f} ms (trips "
              f"{smoke._stats(it_new)}, bound {bms:.5f} ms, {bms / ms:.1%} of it), "
              f"baseline {old_ms:.4f} ms (trips {smoke._stats(it_old)}, bound "
              f"{old_bms:.5f} ms, {old_bms / old_ms:.1%} of it), {old_ms / ms:.2f}x; "
              f"turns {t['old'][0]:.4f} {t['new'][0]:.4f} {t['new'][1]:.4f} "
              f"{t['old'][1]:.4f} ms, {reps} calls each" + tails)


def k3_split(torch, smoke, cgp, ops_128, ops_16k) -> None:
    """Where K3's time goes: this checkout's reduce2_grouped.cu built twice
    more, once with the simulation cut (the identity matrix every group)
    and once with the apply cut (the limbs never change), each run for the
    full kernel's mean group count on the recorded operands. The cuts are
    made on the source text and fail loudly once it no longer matches."""
    src = open(os.path.join(cgp.CSRC_DIR, "reduce2_grouped.cu")).read()

    def cut(text, old, new):
        if text.count(old) != 1:
            smoke.fail(f"k3 split: the source no longer holds {old!r}")
        return text.replace(old, new)

    # the identity matrix from values the compiler cannot fold
    sim_cut = cut(src, "for (int step = 0; step < kSimMax; step++) {",
                  "for (int step = 0; step < 0; step++) {")
    sim_cut = cut(sim_cut, "double p = 1.0, r = 0.0, qq = 0.0, ss = 1.0;",
                  "double p = 1.0 + (dp < -1.0), r = (double)(dp < -2.0), "
                  "qq = (double)(dp < -3.0), ss = 1.0 + (dp < -4.0);")
    apply_cut = cut(src, "    // ---- apply M once to the limbs\n",
                    "    if ((P ^ R ^ Q ^ S) == 0x7fffffffffffLL) a[0]++;\n#if 0\n")
    apply_cut = cut(apply_cut, "      c[j] = nc[j];\n    }\n",
                    "      c[j] = nc[j];\n    }\n#endif\n")
    out_dir = os.path.join(cgp.BUILD_DIR, "k3_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in (("apply_only", sim_cut), ("sim_only", apply_cut)):
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [cgp._nvcc(), *cgp.NVCC_FLAGS, "-I", cgp.CSRC_DIR, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (p, lib) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            smoke.fail(f"k3 split {name} did not build:\n{text}")
        fn = ctypes.CDLL(lib).reduce2_grouped_launch
        fn.restype, fn.argtypes = ctypes.c_int, cgp._ARGTYPES["reduce2_grouped"]
        fns[name] = fn
    for ops in (ops_128, ops_16k):
        a, b, c, dD_mant, dD_top, red_iters = ops
        B, L = a.shape
        iters = torch.zeros(B, dtype=torch.int32, device=a.device)
        full = smoke.timed(torch, lambda: cgp.reduce2_grouped_loop_cuda(
            a, b, c, dD_mant, dD_top, red_iters, iters=iters), smoke.TIMING_REPS)
        groups = int(round(float(iters.float().mean())))
        outs = [torch.empty_like(a) for _ in range(3)]
        res = {"full": full}
        for name, fn in fns.items():
            def go(fn=fn, name=name):
                rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                        *[o.data_ptr() for o in outs], None, B, L, int(dD_top),
                        groups, float(dD_mant), torch.cuda.current_stream().cuda_stream)
                if rc:
                    smoke.fail(f"k3 split {name} launch failed: cudaError {rc}")
            res[name] = smoke.timed(torch, go, smoke.TIMING_REPS)
        smoke.log(f"K3 split B={B}, {groups} groups: " + json.dumps(
            {k: round(v, 4) for k, v in res.items()}) + " ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", required=True,
                    help="a csrc/ directory with the earlier mod_topdown.cu and "
                         "reduce2_grouped.cu")
    ap.add_argument("--k3-split", action="store_true",
                    help="also time K3 with its simulation cut and with its "
                         "apply cut")
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
        for key in sorted(rec.ops, key=lambda k: (k[3], k[0])):
            if key[0] != "xgcd_coeff_g":
                compare_row(torch, smoke, cgp, cg, base, key, rec.ops[key])
        if opts.k3_split:
            k3_split(torch, smoke, cgp, rec.ops[("reduce2_grouped", 144, 0, 128)],
                     rec.ops[("reduce2_grouped", 144, 0, smoke.KERNEL_B)])
    smoke.profile_compose(torch, cg, gmp, hsm, port.bform_from_forms, rng,
                          "this checkout's kernels")
    with baseline_in_place(torch, cgp, base):
        smoke.profile_compose(torch, cg, gmp, hsm, port.bform_from_forms, rng,
                              "baseline K2 and K3")
    smoke.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
