"""Decryption of an n x m ciphertext tensor from a pool encrypted in
set-up, which requests cycle through: on the local deployment the
library's `decrypt_tensor`; on the threshold deployment the client's
`ComputeRequest(UNARY, DECRYPT)` through the compute node, which has t
CoFHE nodes part-decrypt and combines their results.

Compared: every plaintext of every request against the value encrypted
(`wrong_plaintexts`).
"""

from portbench.workload import Pool


def _local(dep, ct) -> list:
    return dep.cs.decrypt_tensor(dep.sk, ct).data


def _threshold(dep, ct) -> list:
    from cofhe_tpu_torch import serialize as ser
    from cofhe_tpu_torch.node import wire

    data = dep.call("UNARY", "DECRYPT", [wire.ComputeOperand(
        wire.DataType.TENSOR, wire.DataEncryptionType.CIPHERTEXT,
        ser.serialize_ciphertext_tensor(ct))])
    return ser.deserialize_plaintext_tensor(data).data


ENTRIES = {"local": _local, "threshold": _threshold}


class Op:
    def __init__(self, dep, group, traffic: dict, seed: int):
        if dep.kind not in ENTRIES:
            raise ValueError(f"decrypt has no entry on the {dep.kind!r} deployment")
        self.dep, self.g, self.entry = dep, group, ENTRIES[dep.kind]
        n, m = traffic["ct_shape"]
        self.pool = Pool(dep, group, seed, (n, m), traffic["pool"])
        self.units = n * m
        self.outputs: dict = {}

    def request(self, i: int, keep: bool = True):
        out = self.entry(self.dep, self.pool.cts[i % len(self.pool.cts)])
        if keep:
            self.outputs[i] = out
        return out

    def compare(self, outputs=None) -> dict:
        outputs = self.outputs if outputs is None else outputs
        wrong = checked = 0
        for i, got in outputs.items():
            want = self.pool.pts[i % len(self.pool.pts)]
            wrong += len(want) - sum(a == b for a, b in zip(got, want))
            checked += len(want)
        return {"wrong_plaintexts": (wrong, 0), "plaintexts_checked": checked}

    def control(self) -> dict:
        """The plaintexts in FP32 precision: mod 2^(k/2)."""
        mod = 1 << (self.g.k // 2)
        return {i: [v % mod for v in self.pool.pts[i % len(self.pool.pts)]]
                for i in self.outputs}
