"""The correctness check fails what it should, on the CPU at toy size
(the harness's look for a card skipped, the rest of a run driven as on
the card): a sound run of each kind of cell is correct, the control (the
reference in the program's place, in the next lower precision) is not,
and neither is a run with the timed path broken underneath by each fault
the cell can have: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced. (A cell on one
card has no exchange between chips to leave out.)"""

import time

import pytest
import torch

from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.core.cl_hsm2k import CipherText
from cofhe_tpu_torch.ops.engine import TorchEngine
from cofhe_tpu_torch.tensor import Tensor
from portbench import harness

import toy

SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    with toy.toy_prime_env(toy.toy_prime()):
        yield toy.make_tree(str(tmp_path_factory.mktemp("bench") / "tree"))


def run(root, cell, control=False):
    res, _ = harness.run_cell(root, cell, SEED, 0.05, False, time.perf_counter(),
                              control=control)
    return res


# --- faults, planted in the engine under the facade and the nodes


def matmul_unchanged(self, s, ct, zero):
    return ct


def matmul_half(self, s, ct, zero):
    out = MATMUL(self, s, ct, zero)
    h = len(out.data) // 2
    return Tensor(out.data[:h] + [zero] * (len(out.data) - h), out.shape)


def matmul_altered(self, s, ct, zero):
    out = MATMUL(self, s, ct, zero)
    return Tensor([out.data[1]] + out.data[1:], out.shape)


def matmul_lane(self, s, ct, zero):
    """One lane of the result, past the first column, altered."""
    out = MATMUL(self, s, ct, zero)
    j = len(out.data) - 2
    return Tensor(out.data[:j] + [CipherText(out.data[j].c1, out.data[j + 1].c2)]
                  + out.data[j + 1:], out.shape)


def pd_unchanged(self, share, cts):
    return [ct.c1 for ct in cts]


def decrypt_half(self, sk, cts):
    return DECRYPT(self, sk, cts[: len(cts) // 2])


def decrypt_altered(self, sk, cts):
    out = DECRYPT(self, sk, cts)
    return [(out[0] + 1) % self.hsm.M] + out[1:]


def combine_half(self, cts, pdrs):
    h = len(cts) // 2
    return COMBINE(self, cts[:h], [p[:h] for p in pdrs])


def combine_altered(self, cts, pdrs):
    out = COMBINE(self, cts, pdrs)
    return [(out[0] + 1) % self.hsm2k.M] + out[1:]


MATMUL = TorchEngine.scal_matmul
DECRYPT = TorchEngine.decrypt_batch
COMBINE = CryptoSystem.combine_part_decryption_results_vector

FAULTS = {
    "local.scal_matmul_2x4x4": {"scal_matmul": (matmul_unchanged, matmul_half, matmul_altered,
                                                matmul_lane)},
    "local.decrypt_2x4": {"part_decrypt_batch": (pd_unchanged,),
                          "decrypt_batch": (decrypt_half, decrypt_altered)},
    "threshold.decrypt_2x4": {"part_decrypt_batch": (pd_unchanged,),
                              # the compute node's combine (the facade's: the
                              # engine's combine_batch takes 64 ciphertexts on)
                              ("facade", "combine_part_decryption_results_vector"):
                              (combine_half, combine_altered)},
}
CASES = [(cell, method, fault) for cell, fs in FAULTS.items()
         for method, faults in fs.items() for fault in faults]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct_and_control_is_not(root, cell):
    res = run(root, cell, control=True)
    assert res["correct"], res["compared"]
    assert all(v["value"] <= v["limit"] for v in res["compared"].values())
    assert any(res["control"][k] > v["limit"] for k, v in res["compared"].items()), res


@pytest.mark.parametrize("cell,method,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, _, f in CASES])
def test_fault_is_not_correct(root, cell, method, fault, monkeypatch):
    if isinstance(method, tuple):
        monkeypatch.setattr(CryptoSystem, method[1], fault)
    else:
        monkeypatch.setattr(TorchEngine, method, fault)
    res = run(root, cell)
    assert not res["correct"], res["compared"]
