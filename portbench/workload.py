"""The general traffic generator: reads a traffic file's parameters, finds
its op by name, and runs the measured window.

A traffic file (portbench/traffic/<name>.json) names an `op` and its
sizes; the op is a file of its own, portbench/ops/<op>.py, found by that
name as metric readers are. It holds one class, `Op(dep, group, traffic,
seed)`, which makes its inputs from the seed, drives the deployment's
entry objects (deploy.py) in `request(i, keep=True)`, keeps what the
comparison needs, and after the window gives `compare(outputs=None)`:
{name: (value, limit)} and plain counts, against the plain reference
(portbench/reference.py); `control()` gives the outputs the reference
computes in the next lower precision, which the comparison has to fail;
`units` is the work a request completes. An op file may also define
`window(op, seconds)`, a loop of its own (open-loop arrivals, several
clients); without one the window is `closed_loop`.

A new mix of an op that exists is a data file alone; a new op is a new
file under portbench/ops. Neither edits a file that is there.
"""

from __future__ import annotations

import importlib.util
import os
import random
import sys
import time


def rng(seed: int, *tag) -> random.Random:
    return random.Random(":".join(str(t) for t in (seed,) + tag))


def load_op(root: str, name: str):
    path = os.path.join(root, "portbench", "ops", f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown traffic op {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_op_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Pool:
    """n x m ciphertext tensors encrypted in set-up, with their plaintexts
    and each tensor's shared parts: c1 = h^r and pk^r = c2 . f^-m (a
    tensor is encrypted with one r, as the upstream encrypt_vector does;
    an element that does not share them fails the comparison)."""

    def __init__(self, dep, group, seed: int, shape, count: int):
        from . import reference as ref

        self.ref, self.shape, self.group = ref, tuple(shape), group
        n = shape[0] * shape[1]
        rngs = [rng(seed, "pool", q) for q in range(count)]
        self.pts = [[r.randrange(group.M) for _ in range(n)] for r in rngs]
        self.cts = [dep.encrypt(v, shape) for v in self.pts]

    def parts(self, q: int):
        """(c1, pk^r) of tensor q, from its first element."""
        ct = self.cts[q].data[0]
        return tuple(ct.c1), self.ref.compose(tuple(ct.c2),
                                              self.group.power_of_f(-self.pts[q][0]))


def send(op, i: int) -> bool:
    """One request; a failure is reported and counted, not raised."""
    try:
        op.request(i)
    except Exception as e:
        print(f"portbench: request {i} failed: {e!r}", file=sys.stderr)
        return False
    return True


def closed_loop(op, seconds: float):
    """One client: a request is sent when the previous one has returned,
    until `seconds` have passed; the request in flight then completes and
    the window ends with it. ([(t0, t1)] of completed requests, failures,
    window seconds)."""
    reqs, failed, i = [], 0, 0
    t_win = time.perf_counter()
    while time.perf_counter() - t_win < seconds and failed <= 3:
        t0 = time.perf_counter()
        if send(op, i):
            reqs.append((t0, time.perf_counter()))
        else:
            failed += 1
        i += 1
    return reqs, failed, (reqs[-1][1] if reqs else time.perf_counter()) - t_win


def make(root: str, dep, group, traffic: dict, seed: int):
    """(the op's object, its window function)."""
    mod = load_op(root, traffic["op"])
    return mod.Op(dep, group, traffic, seed), getattr(mod, "window", closed_loop)
