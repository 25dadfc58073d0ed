"""The port's multi-card data plane (cofhe_tpu_torch.parallel) on the CPU,
over torch.distributed with the gloo backend:

* the single-process semantics of parallel/distributed.py, as
  tests/test_distributed.py checks the JAX module's;
* make_mesh's (dp, tp) factorization against the JAX package's make_mesh;
* ranks of tools/mesh_check.py (one process a rank, one CPU thread each)
  at tests/test_sharding.py's shapes and seeds: a 4-rank dp=2 x tp=2 run
  of the sharded matmul (n, m, p = 2, 4, 2), the tp = t = 2 threshold
  combine of the b"thresh-shard" inputs and a row-sharded add_batch of
  tests/_dist_worker.py's 8 pairs, and a 2-rank dp=2 x tp=1 run (the split
  of the stacked rows alone). Every ciphertext must equal the JAX
  package's mesh engine's (JaxEngine(mesh=...) on the virtual CPU devices
  of tests/conftest.py) and the port's one-process TorchEngine("cpu")'s,
  and the combine must give the plaintexts;
* node.cli --distributed, and ops/matmul2.py's one-device make_matmul_fn
  (phase 1 then phase 2) against the GMP host backend.
Tolerance: exact equality (reduced forms are unique)."""

import random

import jax
import numpy as np
import pytest
import torch

from cofhe_tpu.api import CryptoSystem as JaxCryptoSystem
from cofhe_tpu.core import liss as jliss
from cofhe_tpu.core.rng import RandGen as JRandGen
from cofhe_tpu.ops.engine import JaxEngine
from cofhe_tpu.parallel import sharded as jsharded
from cofhe_tpu.tensor import Tensor as JTensor
from cofhe_tpu_torch.core.cl_hsm2k import CipherText, CLHSM2k
from cofhe_tpu_torch.core.qfi import Form
from cofhe_tpu_torch.core.rng import RandGen
from cofhe_tpu_torch.node import cli
from cofhe_tpu_torch.ops.engine import YAO_W, TorchEngine
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.hostgmp import GmpEngine
from cofhe_tpu_torch.ops.matmul2 import get_plan, make_matmul_fn
from cofhe_tpu_torch.ops.nupow2 import nwind_for_bits, signed_windows
from cofhe_tpu_torch.parallel import distributed as dist
from cofhe_tpu_torch.parallel import sharded
from cofhe_tpu_torch.tensor import Tensor
from cofhe_tpu_torch.tools import mesh_check

torch.set_num_threads(1)

RANK_TIMEOUT_S = 300  # a rank's whole run; ~10-20 s on an idle CPU


def test_init_single_process_noop():
    dist.init(num_processes=1)
    assert not dist._initialized


def test_init_multi_process_requires_coordinator():
    with pytest.raises(ValueError):
        dist.init(num_processes=2, coordinator=None)


def test_global_mesh_axes():
    dist.init(num_processes=1)
    m = dist.global_mesh()
    assert set(m.axis_names) == {"dp", "tp"}
    assert m.size >= 1 and m.coordinate() == (0, 0)


def test_parse_flag():
    assert dist.parse_flag("h:1,4,2") == {
        "coordinator": "h:1", "num_processes": 4, "process_id": 2}
    with pytest.raises(ValueError):
        dist.parse_flag("h:1,4")


@pytest.mark.parametrize("n,dp,tp", [(1, None, None), (2, None, None),
                                     (4, None, None), (8, None, None),
                                     (8, 2, None), (8, None, 2)])
def test_mesh_shape_matches_jax(n, dp, tp):
    jm = jsharded.make_mesh(devices=jax.devices()[:n], dp=dp, tp=tp)
    assert sharded.mesh_shape(n, dp, tp) == (jm.shape["dp"], jm.shape["tp"])


def test_engine_refuses_a_rank_outside_the_mesh(toy_hsm):
    class Outside(sharded.Mesh):
        def coordinate(self):
            return None

    with pytest.raises(ValueError, match="outside the mesh"):
        TorchEngine(CLHSM2k(128, 32, p=toy_hsm.p), "cpu", mesh=Outside(2, 1))


def test_node_cli_distributed_flag_raises():
    with pytest.raises(ValueError, match="--distributed"):
        cli.main(["setup_node", "127.0.0.1", "0", "--device", "cpu",
                  "--distributed", "h:1,4"])


def test_make_matmul_fn_matches_the_gmp_host(toy_hsm):
    hsm = CLHSM2k(128, 32, p=toy_hsm.p)
    rng = RandGen(b"matmul-fn")
    pk = hsm.pk_from_sk(hsm.keygen(rng))
    n, m, pc = 1, 2, 2
    cts = [hsm.encrypt(pk, v, rng) for v in (5, 9)]
    zero = hsm.encrypt(pk, 0, rng)
    sv = [0, 7, hsm.M - 1, 12345]
    eng = TorchEngine(hsm, "cpu")
    nwind = nwind_for_bits(hsm.k, YAO_W)
    plan = get_plan(2 * n, m, pc, nwind, YAO_W)
    recoded = np.array([signed_windows(x, YAO_W, nwind) for x in sv], dtype=np.int32)
    jobs = torch.as_tensor(plan.jobs_b(np.tile(recoded.T, (1, 2 * n))), dtype=torch.long)
    cells = bform_from_forms([c.c1 for c in cts] + [c.c2 for c in cts], eng.L, "cpu")
    zeros = bform_from_forms([zero.c1] * (n * pc) + [zero.c2] * (n * pc), eng.L, "cpu")
    forms = bform_to_forms(make_matmul_fn(eng.cg, plan)(cells, zeros, jobs))
    got = [CipherText(forms[i], forms[n * pc + i]) for i in range(n * pc)]
    want = GmpEngine(hsm).scal_matmul(Tensor(sv, (m, pc)), Tensor(cts, (n, m)), zero)
    assert got == list(want.data)


def _port_ct(x):
    return CipherText(Form(*x[0]), Form(*x[1]))


@pytest.fixture(scope="module")
def mesh_inputs(toy_hsm, tmp_path_factory):
    """The three workloads, written for the ranks, with the JAX mesh
    engine's and the port's one-process results."""
    p = toy_hsm.p
    rnd = random.Random(17)
    # sharded matmul: test_sharding.py's mesh_cs seed and shapes
    jcs = JaxCryptoSystem(128, 32, p=p, seed=b"shard-seed")
    sk = jcs.keygen()
    pk = jcs.keygen(sk)
    n, m, pc = 2, 4, 2
    ct = jcs.encrypt_tensor(pk, JTensor([rnd.randrange(1000) for _ in range(n * m)], (n, m)))
    pt = JTensor([rnd.randrange(1000) for _ in range(m * pc)], (m, pc))
    zero = jcs.encrypt(pk, 0)
    # threshold combine: test_sharding.py's b"thresh-shard" inputs, t = 2 of 3
    rng = JRandGen(b"thresh-shard")
    tsk = toy_hsm.keygen(rng)
    tpk = toy_hsm.pk_from_sk(tsk)
    m_vals = [rnd.randrange(toy_hsm.M) for _ in range(3)]
    tcts = [toy_hsm.encrypt(tpk, v, rng) for v in m_vals]
    shares = jliss.share_secret(tsk, 3, 2, toy_hsm.encrypt_randomness_bound(), rng)
    sh = [shares[q][jliss.share_index_for_party(q, (0, 1), 3)] for q in (0, 1)]
    pdrs = [[toy_hsm.part_decrypt(c, s) for c in tcts] for s in sh]
    # row-sharded add: tests/_dist_worker.py's 8 pairs
    acs = JaxCryptoSystem(128, 32, p=p, seed=b"dist-test")
    apk = acs.keygen(acs.keygen())
    M = toy_hsm.M
    cts1 = [acs.hsm2k.encrypt(apk, (7 * i + 1) % M, acs.rand_gen) for i in range(8)]
    cts2 = [acs.hsm2k.encrypt(apk, (11 * i + 5) % M, acs.rand_gen) for i in range(8)]

    path = str(tmp_path_factory.mktemp("mesh") / "inputs.pkl")
    mesh_check.write_inputs(path, 128, 32, p, add=(cts1, cts2),
                            matmul=(ct, pt, zero), combine=(tcts, pdrs))

    ints = mesh_check.ct_ints
    devs = jax.devices()
    jeng = JaxEngine(toy_hsm, mesh=jsharded.make_mesh(devices=devs[:4], dp=2, tp=2))
    jax_out = {"matmul": [ints(c) for c in jeng.scal_matmul(pt, ct, zero).data],
               "add": [ints(c) for c in jeng.add_batch(cts1, cts2)]}
    jcomb = JaxEngine(toy_hsm, mesh=jsharded.make_mesh(devices=devs[:2], dp=1, tp=2))
    jax_out["combine"] = jcomb.combine_batch(tcts, pdrs)
    assert jax_out["combine"] == m_vals

    def port(cts):
        return [_port_ct(ints(c)) for c in cts]

    eng = TorchEngine(CLHSM2k(128, 32, p=p), "cpu")
    one = {"matmul": [ints(c) for c in eng.scal_matmul(
               Tensor(list(pt.data), pt.shape), Tensor(port(ct.data), ct.shape),
               _port_ct(ints(zero))).data],
           "add": [ints(c) for c in eng.add_batch(port(cts1), port(cts2))],
           "combine": eng.combine_batch(port(tcts), [[Form(f.a, f.b, f.c) for f in q]
                                                     for q in pdrs])}
    return path, jax_out, one, m_vals


def _check(outs, jax_out, one, ops):
    for o in outs:
        for op in ops:
            assert o[op] == jax_out[op], (o["rank"], op, "JAX mesh engine")
            assert o[op] == one[op], (o["rank"], op, "one-process TorchEngine")
        assert o["gathers"]["calls"] > 0 and o["gathers"]["bytes"] > 0


def test_four_ranks_dp2_tp2_match_the_jax_mesh_engine(mesh_inputs, tmp_path):
    path, jax_out, one, m_vals = mesh_inputs
    outs = mesh_check.launch(4, path, str(tmp_path), device="cpu", backend="gloo",
                             dp=2, tp=2, timeout_s=RANK_TIMEOUT_S)
    assert [o["coord"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check(outs, jax_out, one, ("matmul", "add", "combine"))
    assert all(o["combine"] == m_vals for o in outs)
    for o in outs:
        # shard batches: the ladder at rows2_loc * m_loc * p = 2 * 2 * 2
        # lanes (32 on one process), the add at 16 / 4 rows (16)
        assert o["calls"].get("mod_topdown@8", 0) > 0, o["calls"]
        assert "mod_topdown@16" not in o["calls"], o["calls"]
        assert set(o["matmul_phases"]) == {"pack_s", "device_s", "rebuild_s"}


def test_two_ranks_dp2_tp1_split_the_stacked_rows(mesh_inputs, tmp_path):
    path, jax_out, one, _ = mesh_inputs
    outs = mesh_check.launch(2, path, str(tmp_path), device="cpu", backend="gloo",
                             dp=2, tp=1, timeout_s=RANK_TIMEOUT_S)
    assert [o["coord"] for o in outs] == [(0, 0), (1, 0)]
    _check(outs, jax_out, one, ("matmul", "add"))
    assert mesh_check.check_outputs(outs, path) == []


def test_launch_defaults_to_the_card(tmp_path, monkeypatch):
    """mesh_check.launch without device= starts its ranks with --device
    cuda, as its command line does."""
    import pickle

    cmds = []

    class FakeRank:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            out = cmd[cmd.index("--out") + 1]
            with open(out, "wb") as f:
                pickle.dump({"rank": int(cmd[cmd.index("--rank") + 1])}, f)

        def poll(self):
            return 0

    monkeypatch.setattr(mesh_check.subprocess, "Popen", FakeRank)
    outs = mesh_check.launch(2, str(tmp_path / "inputs.pkl"), str(tmp_path))
    assert [o["rank"] for o in outs] == [0, 1]
    assert [c[c.index("--device") + 1] for c in cmds] == ["cuda", "cuda"]
