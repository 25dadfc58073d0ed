"""ct(n x m) . pt(m x p) through the library's `scal_ciphertext_tensors`
(local deployment). Each request a fresh pt of scalars below 2^k drawn
from the seed; the ct tensors a pool encrypted in set-up that requests
cycle through.

Compared, for `check_requests` requests drawn from the seed and
`check_columns` columns of each (all n rows): every result form, a
unique reduced form, against Z . prod_j ct[i, j]^s[j, k] worked out by
the plain reference from the pool's inputs, Z being the request's one
Enc(0), taken from its first compared form (`wrong_forms`: a form that
differs, or is missing; where the first form is the wrong one, every other
form reads wrong). Z has to decrypt to 0 under the seed's key
(`invalid_zero`, the first `check_zero_requests` requests). The pool
tensor's c1 = h^r and pk^r are shared by a column's products, so the
reference raises each to the column's scalar sum, from a fixed-base
table a base, the bases spread over four processes.
"""

from portbench import reference as ref
from portbench.workload import Pool, rng


class Op:
    def __init__(self, dep, group, traffic: dict, seed: int):
        if dep.kind != "local":
            raise ValueError(f"scal_matmul drives the local deployment, not {dep.kind!r}")
        self.dep, self.g, self.seed, self.t = dep, group, seed, traffic
        self.n, self.m = traffic["ct_shape"]
        self.p = traffic["pt_cols"]
        self.pool = Pool(dep, group, seed, (self.n, self.m), traffic["pool"])
        self.units = self.n * self.m * self.p
        self.outputs: dict = {}
        self._powers: dict = {}

    def scalars(self, i: int) -> list:
        r = rng(self.seed, "pt", i)
        return [r.randrange(self.g.M) for _ in range(self.m * self.p)]

    def request(self, i: int, keep: bool = True):
        from cofhe_tpu_torch.tensor import Tensor

        out = self.dep.cs.scal_ciphertext_tensors(
            self.dep.pk, Tensor(self.scalars(i), (self.m, self.p)),
            self.pool.cts[i % len(self.pool.cts)])
        if keep:
            self.outputs[i] = out
        return out

    def _sample(self):
        """(request, columns) pairs to compare, drawn from the seed."""
        done = sorted(self.outputs)
        r = rng(self.seed, "check")
        reqs = sorted(r.sample(done, min(self.t["check_requests"], len(done))))
        return [(i, sorted(r.sample(range(self.p), self.t["check_columns"]))) for i in reqs]

    def _columns(self, i: int, cols, mod: int):
        """{col: (c1^S, (pk^r)^S, [M of each row])}: the column's shared
        parts (`_raise` them first) and its plaintext sums, taken mod
        `mod`."""
        s, pts = self.scalars(i), self.pool.pts[i % len(self.pool.pts)]
        out = {}
        for k in cols:
            col = [s[j * self.p + k] for j in range(self.m)]
            out[k] = (*self._powers[i, k],
                      [sum(a * b for a, b in zip(col, pts[row * self.m:(row + 1) * self.m]))
                       % mod for row in range(self.n)])
        return out

    def _raise(self, sample) -> None:
        """The pool tensor's c1 and pk^r to each compared column's scalar
        sum, once a run."""
        todo = [(i, [k for k in cols if (i, k) not in self._powers]) for i, cols in sample]
        todo = [(i, cols) for i, cols in todo if cols]
        jobs = []
        for i, cols in todo:
            s = self.scalars(i)
            sums = [sum(s[j * self.p + k] for j in range(self.m)) for k in cols]
            jobs += [(base, sums) for base in self.pool.parts(i % len(self.pool.cts))]
        done = ref.powers_in_parallel(jobs)
        for n, (i, cols) in enumerate(todo):
            for k, x1, x2 in zip(cols, done[2 * n], done[2 * n + 1]):
                self._powers[i, k] = (x1, x2)

    def compare(self, outputs=None) -> dict:
        """`outputs`: request -> its ciphertexts by index (the program's by
        default)."""
        if outputs is None:
            outputs = {i: t.data for i, t in self.outputs.items()}

        def got(i, row, k):
            try:
                g1, g2 = outputs[i][row * self.p + k]
                return tuple(g1), tuple(g2)
            except (IndexError, KeyError, TypeError, ValueError):  # a result cut short
                return None

        wrong = zero_invalid = checked = 0
        sample = self._sample()
        self._raise(sample)
        for n_req, (i, cols) in enumerate(sample):
            expect = self._columns(i, cols, self.g.M)
            first = next(((row, k) for k in cols for row in range(self.n)
                          if got(i, row, k) is not None), None)
            checked += len(cols) * self.n
            if first is None:
                wrong += len(cols) * self.n
                zero_invalid += n_req < self.t["check_zero_requests"]
                continue
            row0, k0 = first
            C1, P, Ms = expect[k0]
            g1, g2 = got(i, row0, k0)
            z1 = ref.compose(g1, ref.neg(C1))
            z2 = ref.compose(g2, ref.neg(ref.compose(P, self.g.power_of_f(Ms[row0]))))
            for k in cols:
                C1, P, Ms = expect[k]
                e1, pz = ref.compose(C1, z1), ref.compose(P, z2)
                for row in range(self.n):
                    g = got(i, row, k)
                    wrong += g is None or g[0] != e1 or \
                        g[1] != ref.compose(pz, self.g.power_of_f(Ms[row]))
            if n_req < self.t["check_zero_requests"]:
                zero_invalid += ref.power(z1, self.dep.sk) != z2
        return {"wrong_forms": (wrong, 0), "invalid_zero": (zero_invalid, 0),
                "forms_checked": checked}

    def control(self) -> dict:
        """Outputs of the reference in FP32 precision (plaintext sums mod
        2^(k/2)) at the compared elements, Enc(0) the identity."""
        out, sample = {}, self._sample()
        self._raise(sample)
        for i, cols in sample:
            cs = self._columns(i, cols, 1 << (self.g.k // 2))
            out[i] = {row * self.p + k: (C1, ref.compose(P, self.g.power_of_f(Ms[row])))
                      for k, (C1, P, Ms) in cs.items() for row in range(self.n)}
        return out
