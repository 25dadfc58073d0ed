"""One rank of a meshed TorchEngine run, and the launcher of all ranks.

    python -m cofhe_tpu_torch.tools.mesh_check --rank R --world W \\
        --coordinator HOST:PORT --device cuda|cpu --backend nccl|gloo \\
        --dp D --tp T --inputs FILE --out FILE
    python -m cofhe_tpu_torch.tools.mesh_check --launch W --device ... \\
        --backend ... --dp D --tp T --inputs FILE --out DIR
    python -m cofhe_tpu_torch.tools.mesh_check --make-inputs --inputs FILE

Every rank joins one torch.distributed process group, builds a (dp, tp)
mesh over it and a TorchEngine(mesh=...) on its device, and runs, SPMD on
the same inputs, whichever of these the input file holds:

  * "add":     add_batch(cts1, cts2), row-sharded over the mesh;
  * "matmul":  scal_matmul(pt, ct, zero) with the given Enc(0), the dp x tp
               sharded matmul;
  * "combine": combine_batch(cts, pdrs), over tp when tp == t.

The input file is a pickle of plain integers (`write_inputs`): forms are
(a, b, c) tuples and ciphertexts pairs of forms, so that any package can
write it; it may hold the results expected of each op. The output file
holds the rank's results in the same encoding, the kernels it ran by
(kernel, batch) as `count_calls` counts them (graph replays included),
its kernel launches on a card, its gathers and its seconds. `launch`
starts all ranks as subprocesses, each with a time limit, kills them all
as soon as one fails and raises with that rank's log; `check_outputs`
holds the ranks to each other and to the expected results.
The tests and chip_smoke.py drive the ranks through them, and `--launch W`
does from the command line (exit 1 on any difference). `--make-inputs`
writes a seeded input file at chip_smoke.py's configuration with its
expected results, computed on the GMP host backend: at sec=128, k=128 a
ct(2 x 64) . pt(64 x 64) matmul, the 64 adds of the ciphertext's two rows
and a t=2 of 3 combine of its first 16 ciphertexts. Every rank runs one
CPU thread.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OPS = ("add", "matmul", "combine")


class MeshCheckError(RuntimeError):
    pass


def form_ints(f) -> tuple:
    return (int(f.a), int(f.b), int(f.c))


def ct_ints(ct) -> tuple:
    return (form_ints(ct.c1), form_ints(ct.c2))


def write_inputs(path: str, sec: int, k: int, p: int | None, expect=None,
                 **ops) -> None:
    """ops: add=(cts1, cts2), matmul=(ct Tensor, pt Tensor, zero ct),
    combine=(cts, pdrs_per_party); ciphertexts and forms of any package.
    expect: {op: ciphertexts (add, matmul) or plaintexts (combine)}."""
    data = {"sec": sec, "k": k, "p": p, "expect": {
        op: [int(x) for x in v] if op == "combine" else [ct_ints(c) for c in v]
        for op, v in (expect or {}).items()}}
    if "add" in ops:
        cts1, cts2 = ops["add"]
        data["add"] = ([ct_ints(c) for c in cts1], [ct_ints(c) for c in cts2])
    if "matmul" in ops:
        ct, pt, zero = ops["matmul"]
        data["matmul"] = ([ct_ints(c) for c in ct.data], tuple(ct.shape),
                          [int(x) for x in pt.data], tuple(pt.shape), ct_ints(zero))
    if "combine" in ops:
        cts, pdrs = ops["combine"]
        data["combine"] = ([ct_ints(c) for c in cts],
                           [[form_ints(f) for f in party] for party in pdrs])
    with open(path, "wb") as f:
        pickle.dump(data, f)


def make_inputs(path: str) -> None:
    """Seeded inputs at chip_smoke.py's configuration and their expected
    results from the GMP host backend."""
    import random

    from ..api import CryptoSystem
    from ..core import liss
    from ..tensor import Tensor

    sec, k, n, m, p, seed = 128, 128, 2, 64, 64, b"mesh-check"
    cs = CryptoSystem(sec, k, device="host", seed=seed)
    sk = cs.keygen()
    pk = cs.keygen(sk)
    rnd = random.Random(seed)
    ctv = [rnd.randrange(cs.hsm2k.M) for _ in range(n * m)]
    ct = cs.encrypt_tensor(pk, Tensor(ctv, (n, m)))
    pt = Tensor([rnd.randrange(cs.hsm2k.M) for _ in range(m * p)], (m, p))
    zero = cs.encrypt(pk, 0)
    half = n * m // 2
    cts1, cts2 = ct.data[:half], ct.data[half:2 * half]
    shares = cs.keygen(sk, 2, 3)
    sh = [shares[q][liss.share_index_for_party(q, (0, 1), 3)] for q in (0, 1)]
    comb = ct.data[:16]
    pdrs = [cs.part_decrypt_vector(s, comb) for s in sh]
    gmp = cs._engine
    write_inputs(path, sec, k, cs.hsm2k.p, add=(cts1, cts2), matmul=(ct, pt, zero),
                 combine=(comb, pdrs), expect={
                     "matmul": gmp.scal_matmul(pt, ct, zero).data,
                     "add": gmp.add_batch(cts1, cts2), "combine": ctv[:16]})


def count_calls(cuda_group, graphs) -> dict:
    """Count the kernels run by 'kernel@batch' (batch: the rows of the
    tensor that picks the dispatcher's route, cuda_group.DISPATCH), apart
    from cuda_group's own counters: each call of a
    dispatcher outside a graph capture (one launch on a card, the plain
    version on the CPU) and, for each replay of a
    compose2 graph or launch of a ladder step graph, each kernel it
    captured. On a card the counts must
    equal cuda_group.LAUNCHES; `.clear()` the dict to start over."""
    import torch

    calls: dict = {}
    lock = threading.Lock()

    def add(key: str, n: int = 1) -> None:
        with lock:
            calls[key] = calls.get(key, 0) + n

    for name, d in cuda_group.DISPATCH.items():
        def counted(*a, _orig=getattr(cuda_group, d.name), _name=name, _route=d.route, **kw):
            t = _route(a)
            if not (t.is_cuda and torch.cuda.is_current_stream_capturing()):
                add(f"{_name}@{math.prod(t.shape[:-1])}")
            return _orig(*a, **kw)

        setattr(cuda_group, d.name, counted)
    replay = graphs.ComposeGraph.run

    def replayed(g, F1, F2):
        out = replay(g, F1, F2)
        for name, _, _, batch in g.keys:
            add(f"{name}@{batch}")
        return out

    graphs.ComposeGraph.run = replayed
    ladder = graphs.LadderGraphs.run

    def laddered(lg, *a, **kw):
        before = [rec.replays for rec in lg.launches]
        out = ladder(lg, *a, **kw)
        for rec, b in zip(lg.launches, before):
            for (name, _, _, batch), c in rec.per_replay.items():
                add(f"{name}@{batch}", c * (rec.replays - b))
        return out

    graphs.LadderGraphs.run = laddered
    return calls


def run_rank(args) -> dict:
    import torch

    torch.set_num_threads(1)
    from ..core.cl_hsm2k import CipherText, CLHSM2k
    from ..core.qfi import Form
    from ..ops import cuda_group, graphs
    from ..ops.engine import TorchEngine
    from ..parallel import distributed, sharded
    from ..tensor import Tensor
    from ..utils.benchmark import PhaseTimer

    with open(args.inputs, "rb") as f:
        data = pickle.load(f)

    def ct(x):
        return CipherText(Form(*x[0]), Form(*x[1]))

    timer = PhaseTimer(args.device)
    with timer("init"):
        distributed.init(args.coordinator, args.world, args.rank,
                         backend=args.backend, timeout_s=args.timeout)
        mesh = sharded.make_mesh(dp=args.dp, tp=args.tp)
        hsm = CLHSM2k(data["sec"], data["k"], p=data["p"])
        eng = TorchEngine(hsm, args.device, mesh=mesh)
    calls = count_calls(cuda_group, graphs)
    cuda_group.reset_launches()
    sharded.GATHERS.update(calls=0, bytes=0)
    out = {"rank": args.rank, "coord": eng._coord, "mesh": (mesh.dp, mesh.tp)}
    for op in OPS:
        if op not in data:
            continue
        with timer(op):
            if op == "add":
                got = eng.add_batch([ct(x) for x in data["add"][0]],
                                    [ct(x) for x in data["add"][1]])
                out[op] = [ct_ints(c) for c in got]
            elif op == "matmul":
                cts, shape, pt, pt_shape, zero = data["matmul"]
                res = eng.scal_matmul(Tensor(pt, pt_shape),
                                      Tensor([ct(x) for x in cts], shape), ct(zero))
                out[op] = [ct_ints(c) for c in res.data]
                out["matmul_phases"] = dict(getattr(eng, "last_sharded_phases", {}))
            else:
                cts, pdrs = data["combine"]
                out[op] = eng.combine_batch(
                    [ct(x) for x in cts], [[Form(*f) for f in p] for p in pdrs])
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
    out.update(calls=calls, launches=dict(cuda_group.LAUNCHES),
               gathers=dict(sharded.GATHERS), seconds=dict(timer.phases))
    torch.distributed.destroy_process_group()
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, inputs: str, out_dir: str, *, device: str = "cuda",
           backend: str | None = None, dp: int | None = None,
           tp: int | None = None, timeout_s: float = 600.0) -> list[dict]:
    """Run `world` ranks on `inputs`, logs and outputs under out_dir; the
    ranks' outputs in rank order. Raises MeshCheckError, with the failing
    rank's log, when a rank exits non-zero or the time limit passes; every
    rank still running is killed first."""
    os.makedirs(out_dir, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", "cofhe_tpu_torch.tools.mesh_check",
                   "--rank", str(r), "--world", str(world),
                   "--coordinator", coordinator, "--device", device,
                   "--inputs", inputs, "--out", os.path.join(out_dir, f"rank{r}.pkl"),
                   "--timeout", str(timeout_s)]
            for flag, v in (("--backend", backend), ("--dp", dp), ("--tp", tp)):
                if v is not None:
                    cmd += [flag, str(v)]
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                           cwd=ROOT), log))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise MeshCheckError(f"rank {bad[0]} of {world} exited with "
                                     f"{codes[bad[0]]}:\n" + _log(out_dir, bad[0]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise MeshCheckError(f"ranks still running after {timeout_s} s:\n"
                                     + _log(out_dir, codes.index(None)))
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def check_outputs(outs: list[dict], inputs: str) -> list[str]:
    """What is wrong with the ranks' outputs: an op whose result differs
    between ranks or from the expected result, a rank that never gathered."""
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    problems = []
    for op in OPS:
        if op not in data:
            continue
        for o in outs[1:]:
            if o[op] != outs[0][op]:
                problems.append(f"rank {o['rank']}'s {op} differs from rank 0's")
        if op in data["expect"] and outs[0][op] != data["expect"][op]:
            problems.append(f"{op} differs from the expected results")
    problems += [f"rank {o['rank']} never gathered" for o in outs
                 if len(outs) > 1 and o["gathers"]["calls"] <= 0]
    return problems


def _log(out_dir: str, rank: int) -> str:
    with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
        return f.read()[-8000:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mesh_check", description=__doc__.split("\n")[0])
    ap.add_argument("--launch", type=int, default=None, metavar="W",
                    help="start W ranks on this machine; --out is their directory")
    ap.add_argument("--make-inputs", action="store_true",
                    help="write --inputs (GMP host backend) and exit")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--coordinator", help="host:port of rank 0")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl with a card, gloo without; ranks "
                         "that share one card need gloo")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a collective waits for the other ranks")
    args = ap.parse_args(argv)
    if args.make_inputs:
        make_inputs(args.inputs)
        return 0
    if args.out is None:
        ap.error("--out is required")
    if args.launch:
        import json

        outs = launch(args.launch, args.inputs, args.out, device=args.device,
                      backend=args.backend, dp=args.dp, tp=args.tp,
                      timeout_s=args.timeout)
        for o in outs:
            print(json.dumps({k: o[k] for k in ("rank", "coord", "mesh", "calls",
                                                "launches", "gathers", "seconds")}
                             | {"matmul_phases": o.get("matmul_phases")}))
        problems = check_outputs(outs, args.inputs)
        print("mesh_check: " + ("; ".join(problems) if problems else
                                f"{args.launch} ranks agree with each other and "
                                "with the expected results"), flush=True)
        return 1 if problems else 0
    if args.rank is None or args.world is None or args.coordinator is None:
        ap.error("a rank needs --rank, --world and --coordinator")
    out = run_rank(args)
    with open(args.out + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(args.out + ".tmp", args.out)
    print(f"mesh_check rank {args.rank}/{args.world} at {out['coord']} of "
          f"{out['mesh']}: ok, seconds {out['seconds']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
