"""The port's threshold network (cofhe_tpu_torch.smpc / .node) on the toy
parameters (k=32, 100-bit p):

* the Beaver data plane (`SMPCCipherTextMultiplier._beaver_batch`) of both
  packages, each with a stub SMPC client holding the same triplets and
  opening with the dealer's key, gives identical product ciphertexts;
* the in-process network of tests/test_network.py (1 setup + 3 CoFHE + 1
  compute node, t=2, n=3) on the port's nodes: setup, compute, client and
  CoFHE node 0 on "cpu" (the kernels' plain torch versions), CoFHE nodes 1
  and 2 on "host" (GMP); the flows of tests/test_network.py:64-166, its TLS
  flow, and the JAX package's ClientNode against the port's nodes (the wire
  format);
* the setup node's checkpoint resume (tests/test_checkpoint.py:23) and the
  "cuda" defaults of every node entry point.
Tolerance: exact equality of plaintexts and ciphertext forms."""

import inspect
import os
import socket

import pytest
import torch

from cofhe_tpu.api import CryptoSystem as JaxCryptoSystem
from cofhe_tpu.core import cl_hsm2k as jax_cl_hsm2k
from cofhe_tpu.core.cl_hsm2k import CipherText as JCipherText
from cofhe_tpu.core.qfi import Form as JForm
from cofhe_tpu.smpc.multiplier import SMPCCipherTextMultiplier as JaxMultiplier
from cofhe_tpu.tensor import Tensor as JTensor
from cofhe_tpu_torch import serialize as ser
from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.core import cl_hsm2k
from cofhe_tpu_torch.node import cli, handlers, nodes, wire
from cofhe_tpu_torch.node.handlers import SetupNodeHandler
from cofhe_tpu_torch.node.network_details import (CryptoSystemDetails,
                                                  NodeDetails, NodeType)
from cofhe_tpu_torch.smpc.multiplier import SMPCCipherTextMultiplier
from cofhe_tpu_torch.tensor import Tensor

torch.set_num_threads(1)

TRIPLET_CACHE = 16  # triplets a refill deals (the runtime's default is 1024)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def toy_params(toy_hsm):
    """COFHE_P_OVERRIDE for every node of the process, with both packages'
    parameter caches cleared before and after."""
    os.environ["COFHE_P_OVERRIDE"] = hex(toy_hsm.p)
    cl_hsm2k._cached_params.cache_clear()
    jax_cl_hsm2k._cached_params.cache_clear()
    yield toy_hsm.p
    os.environ.pop("COFHE_P_OVERRIDE", None)
    cl_hsm2k._cached_params.cache_clear()
    jax_cl_hsm2k._cached_params.cache_clear()


def start_network(certfile=None, keyfile=None):
    """The port's 5-node network; returns (setup node, setup handler,
    compute handler, servers)."""
    ports = [free_port() for _ in range(5)]
    tls = dict(certfile=certfile, keyfile=keyfile)
    setup_nd = NodeDetails("127.0.0.1", str(ports[0]), NodeType.SETUP_NODE)
    cs_details = CryptoSystemDetails(type="CoFHE_GPU", public_key="",
                                     security_level=128, k=32, threshold=2,
                                     total_nodes=3)
    servers = []
    try:
        server, setup_handler = nodes.make_setup_node(setup_nd, cs_details,
                                                      device="cpu", **tls)
        server.run_in_thread()
        servers.append(server)
        for i, dev in zip(range(1, 4), ("cpu", "host", "host")):
            nd = NodeDetails("127.0.0.1", str(ports[i]), NodeType.COFHE_NODE)
            server = nodes.make_cofhe_node(nd, setup_nd, device=dev, **tls)
            server.run_in_thread()
            servers.append(server)
        nd = NodeDetails("127.0.0.1", str(ports[4]), NodeType.COMPUTE_NODE)
        server = nodes.make_compute_node(nd, setup_nd, device="cpu", **tls)
        server.run_in_thread()
        servers.append(server)
    except BaseException:
        for s in servers:
            s.stop()
        raise
    compute = server.handler.__self__
    compute.smpc.cache_size = TRIPLET_CACHE
    return setup_nd, setup_handler, compute, servers


@pytest.fixture(scope="module")
def network(toy_params):
    setup_nd, setup_handler, compute, servers = start_network()
    client = nodes.ClientNode(setup_nd, use_tls=False, device="cpu")
    yield client, setup_handler, compute, setup_nd
    client.close()
    for s in servers:
        s.stop()


def _op(dt, et, data):
    return wire.ComputeOperand(dt, et, data)


def _ct_single(cs, ct):
    return _op(wire.DataType.SINGLE, wire.DataEncryptionType.CIPHERTEXT,
               cs.serialize_ciphertext(ct).encode())


def _ct_tensor(ct):
    return _op(wire.DataType.TENSOR, wire.DataEncryptionType.CIPHERTEXT,
               ser.serialize_ciphertext_tensor(ct))


def _compute(client, op_type, op, operands):
    resp = client.compute(wire.ComputeRequest(op_type, op, operands))
    assert resp.status == wire.Status.OK, resp.data[:300]
    return resp.data


def _decrypt_tensor(client, ct):
    data = _compute(client, wire.ComputeOperationType.UNARY,
                    wire.ComputeOperation.DECRYPT, [_ct_tensor(ct)])
    return ser.deserialize_plaintext_tensor(data)


def test_single_ct_ct_multiply_and_decrypt(network):
    client, _, compute, _ = network
    cs, pk = client.crypto_system, client.public_key
    ct1 = cs.encrypt(pk, cs.make_plaintext(2.0))
    ct2 = cs.encrypt(pk, cs.make_plaintext(3.0))
    data = _compute(client, wire.ComputeOperationType.BINARY,
                    wire.ComputeOperation.MULTIPLY,
                    [_ct_single(cs, ct1), _ct_single(cs, ct2)])
    prod = cs.deserialize_ciphertext(data.decode())
    data = _compute(client, wire.ComputeOperationType.UNARY,
                    wire.ComputeOperation.DECRYPT, [_ct_single(cs, prod)])
    assert cs.get_float_from_plaintext(cs.deserialize_plaintext(data.decode())) == 6.0
    # the opening round ran on the first t = 2 CoFHE nodes
    assert compute.smpc._combo == (0, 1)


def test_tensor_add_and_decrypt(network):
    client, _, _, _ = network
    cs, pk = client.crypto_system, client.public_key
    ca = cs.encrypt_tensor(pk, Tensor([cs.make_plaintext(float(i)) for i in range(4)], (2, 2)))
    cb = cs.encrypt_tensor(pk, Tensor([cs.make_plaintext(float(10 * i)) for i in range(4)], (2, 2)))
    data = _compute(client, wire.ComputeOperationType.BINARY,
                    wire.ComputeOperation.ADD, [_ct_tensor(ca), _ct_tensor(cb)])
    out = _decrypt_tensor(client, ser.deserialize_ciphertext_tensor(data))
    assert out.shape == (2, 2)
    assert [cs.get_float_from_plaintext(v) for v in out.data] == [0.0, 11.0, 22.0, 33.0]


def test_tensor_ct_pt_matmul(network):
    client, setup_handler, _, _ = network
    cs, pk = client.crypto_system, client.public_key
    xs = [[1.0, 2.0], [3.0, 4.0]]
    ws = [[5.0, 6.0], [7.0, 8.0]]
    ct = cs.encrypt_tensor(pk, Tensor([cs.make_plaintext(v) for r in xs for v in r], (2, 2)))
    pt = Tensor([cs.make_plaintext(v) for r in ws for v in r], (2, 2))
    data = _compute(client, wire.ComputeOperationType.BINARY,
                    wire.ComputeOperation.MULTIPLY,
                    [_ct_tensor(ct), _op(wire.DataType.TENSOR,
                                         wire.DataEncryptionType.PLAINTEXT,
                                         ser.serialize_plaintext_tensor(pt))])
    prod = ser.deserialize_ciphertext_tensor(data)
    sk = setup_handler.sk  # the dealer's key, on the host
    got = [cs.get_float_from_plaintext(setup_handler.cs.decrypt(sk, c)) for c in prod.data]
    assert got == [sum(xs[i][j] * ws[j][k] for j in range(2))
                   for i in range(2) for k in range(2)]


def test_tensor_ct_ct_beaver_matmul(network):
    """The products' opening round runs through the network; the result is
    decrypted with the dealer's key on the host (the network's tensor
    decrypt is test_tensor_add_and_decrypt's)."""
    client, setup_handler, _, _ = network
    cs, pk = client.crypto_system, client.public_key
    xs = [[1.0, 2.0], [3.0, 4.0]]
    ys = [[2.0, 0.0], [1.0, 3.0]]
    ct1 = cs.encrypt_tensor(pk, Tensor([cs.make_plaintext(v) for r in xs for v in r], (2, 2)))
    ct2 = cs.encrypt_tensor(pk, Tensor([cs.make_plaintext(v) for r in ys for v in r], (2, 2)))
    data = _compute(client, wire.ComputeOperationType.BINARY,
                    wire.ComputeOperation.MULTIPLY, [_ct_tensor(ct1), _ct_tensor(ct2)])
    prod = ser.deserialize_ciphertext_tensor(data)
    assert prod.shape == (2, 2)
    got = [cs.get_float_from_plaintext(setup_handler.cs.decrypt(setup_handler.sk, c))
           for c in prod.data]
    assert got == [sum(xs[i][j] * ys[j][k] for j in range(2))
                   for i in range(2) for k in range(2)]


def test_compute_errors_travel_in_the_inner_status(network):
    client, _, _, _ = network
    resp = client.compute(wire.ComputeRequest(
        wire.ComputeOperationType.UNARY, wire.ComputeOperation.ADD, []))
    assert resp.status == wire.Status.ERROR


def test_jax_client_against_the_port_network(network):
    """The JAX package's ClientNode (GMP host) drives the port's nodes: the
    wire format of both packages is one."""
    from cofhe_tpu import serialize as jser
    from cofhe_tpu.node import wire as jwire
    from cofhe_tpu.node.network_details import NodeDetails as JNodeDetails
    from cofhe_tpu.node.network_details import NodeType as JNodeType
    from cofhe_tpu.node.nodes import ClientNode as JaxClientNode

    _, setup_handler, _, setup_nd = network
    client = JaxClientNode(JNodeDetails(setup_nd.ip, setup_nd.port,
                                        JNodeType.SETUP_NODE),
                           use_tls=False, device="host")
    try:
        cs, pk = client.crypto_system, client.public_key
        assert tuple(pk) == tuple(setup_handler.pk)
        vals = [cs.make_plaintext(v) for v in (1.0, -2.0, 30.0, 4.0)]
        ca = cs.encrypt_tensor(pk, JTensor(vals, (2, 2)))
        cb = cs.encrypt_tensor(pk, JTensor(vals, (2, 2)))
        ops = [jwire.ComputeOperand(jwire.DataType.TENSOR,
                                    jwire.DataEncryptionType.CIPHERTEXT,
                                    jser.serialize_ciphertext_tensor(t)) for t in (ca, cb)]
        resp = client.compute(jwire.ComputeRequest(
            jwire.ComputeOperationType.BINARY, jwire.ComputeOperation.ADD, ops))
        assert resp.status == jwire.Status.OK, resp.data[:300]
        sums = jser.deserialize_ciphertext_tensor(resp.data)
        assert sums.shape == (2, 2)
        got = []
        for ct in sums.data:  # threshold decrypts through the port's nodes
            resp = client.compute(jwire.ComputeRequest(
                jwire.ComputeOperationType.UNARY, jwire.ComputeOperation.DECRYPT,
                [jwire.ComputeOperand(jwire.DataType.SINGLE,
                                      jwire.DataEncryptionType.CIPHERTEXT,
                                      cs.serialize_ciphertext(ct).encode())]))
            assert resp.status == jwire.Status.OK, resp.data[:300]
            got.append(cs.get_float_from_plaintext(
                cs.deserialize_plaintext(resp.data.decode())))
        assert got == [2.0, -4.0, 60.0, 8.0]
    finally:
        client.close()


def test_tls_end_to_end(toy_params, tmp_path):
    """Join, topology fetch, homomorphic add and threshold decrypt over TLS
    (self-signed certificate, client verify_none as in the reference)."""
    from cofhe_tpu_torch.node.server import generate_self_signed_cert

    cert, key = str(tmp_path / "server.pem"), str(tmp_path / "server_key.pem")
    generate_self_signed_cert(cert, key)
    setup_nd, _, _, servers = start_network(certfile=cert, keyfile=key)
    try:
        client = nodes.ClientNode(setup_nd, use_tls=True, device="cpu")
        cs, pk = client.crypto_system, client.public_key
        ct1 = cs.encrypt(pk, cs.make_plaintext(4.0))
        ct2 = cs.encrypt(pk, cs.make_plaintext(5.0))
        data = _compute(client, wire.ComputeOperationType.BINARY,
                        wire.ComputeOperation.ADD,
                        [_ct_single(cs, ct1), _ct_single(cs, ct2)])
        ct_sum = cs.deserialize_ciphertext(data.decode())
        data = _compute(client, wire.ComputeOperationType.UNARY,
                        wire.ComputeOperation.DECRYPT, [_ct_single(cs, ct_sum)])
        assert cs.get_float_from_plaintext(cs.deserialize_plaintext(data.decode())) == 9.0
        client.close()
    finally:
        for s in servers:
            s.stop()


# ------------------------------------------------- the Beaver data plane


class _StubSMPC:
    """Holds fixed triplets and opens ciphertexts with the dealer's key."""

    def __init__(self, cs, sk, triplets, tensor_type):
        self.cs, self.sk, self.triplets = cs, sk, triplets
        self.tensor_type = tensor_type

    def get_beavers_triplets(self, n):
        out, self.triplets = self.triplets[:n], self.triplets[n:]
        return out

    def decrypt_tensor(self, ct):
        return self.tensor_type([self.cs.decrypt(self.sk, c) for c in ct.data],
                                ct.shape)


def test_beaver_batch_matches_the_jax_package(toy_cs):
    """Both packages' _beaver_batch on the same inputs, triplets and seed:
    one vector add of the differences, one opening, one batched encrypt,
    two vector scals and three vector adds, bit for bit (the port on its
    plain torch kernels, the JAX package on its host engine)."""
    p = toy_cs.hsm2k.p
    pcs = CryptoSystem(128, 32, p=p, seed=b"beaver", device="cpu")
    jcs = JaxCryptoSystem(128, 32, p=p, seed=b"beaver", device="host")
    sk = pcs.keygen()
    pk = pcs.keygen(sk)
    assert jcs.keygen() == sk
    jpk = jcs.keygen(sk)
    n = 3
    trip = [pcs.generate_random_beavers_triplet() for _ in range(n)]
    tcts = pcs.encrypt_vector(pk, [v for t in trip for v in t])
    triplets = [tuple(tcts[3 * i:3 * i + 3]) for i in range(n)]
    xs = pcs.encrypt_vector(pk, [5, 6, 7])
    ys = pcs.encrypt_vector(pk, [11, 0, 13])
    for _ in range(2 * n):  # the JAX generator draws what the port's drew
        jcs.rand_gen.random_mpz(10)
    for _ in range(3):
        jcs.rand_gen.random_mpz(jcs.hsm2k.encrypt_randomness_bound())

    def jct(c):
        return JCipherText(JForm(*c.c1), JForm(*c.c2))

    pm = SMPCCipherTextMultiplier.__new__(SMPCCipherTextMultiplier)
    pm.smpc, pm.cs, pm.pk = _StubSMPC(pcs, sk, triplets, Tensor), pcs, pk
    jm = JaxMultiplier.__new__(JaxMultiplier)
    jm.smpc = _StubSMPC(jcs, sk, [tuple(jct(c) for c in t) for t in triplets], JTensor)
    jm.cs, jm.pk = jcs, jpk
    assert pcs.rand_gen.random_mpz(1 << 64) == jcs.rand_gen.random_mpz(1 << 64)
    got = pm._beaver_batch(xs, ys)
    want = jm._beaver_batch([jct(c) for c in xs], [jct(c) for c in ys])
    assert [(tuple(c.c1), tuple(c.c2)) for c in got] == \
        [(tuple(c.c1), tuple(c.c2)) for c in want]
    assert [pcs.decrypt(sk, c) for c in got] == [55, 0, 91]


# -------------------------------------------- checkpoint and the defaults


def test_checkpoint_resume(toy_params, tmp_path):
    state = str(tmp_path / "setup_state.json")
    self_node = NodeDetails("127.0.0.1", "9999", NodeType.SETUP_NODE)
    h1 = SetupNodeHandler(self_node, CryptoSystemDetails("CoFHE_GPU", "", 128, 32, 2, 3),
                          device="cpu", state_path=state)
    h1._handle_join(wire.JoinAsNodeRequest(wire.JoinType.JOIN_AS_COFHE_NODE, "1.2.3.4", "1"))
    h1._handle_join(wire.JoinAsNodeRequest(wire.JoinType.JOIN_AS_COMPUTE_NODE, "1.2.3.4", "2"))
    ct = h1.cs.encrypt(h1.pk, 1234)
    h2 = SetupNodeHandler(self_node, CryptoSystemDetails("CoFHE_GPU", "", 128, 32, 2, 3),
                          device="cpu", state_path=state)
    assert (h2.sk, h2.pk, h2.rank_shares) == (h1.sk, h1.pk, h1.rank_shares)
    assert h2._next_party == 1 and len(h2.nodes) == 3
    assert h2.cs.decrypt(h2.sk, ct) == 1234
    with pytest.raises(ValueError):
        SetupNodeHandler(self_node, CryptoSystemDetails("CoFHE_GPU", "", 128, 32, 2, 4),
                         device="cpu", state_path=state)


def test_node_entry_points_default_to_cuda(toy_params, monkeypatch):
    for fn in (nodes.make_setup_node, nodes.make_cofhe_node,
               nodes.make_compute_node, nodes.ClientNode,
               handlers.SetupNodeHandler, handlers.CoFHENodeHandler,
               handlers.ComputeNodeHandler):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = []

    def fake_setup(self_node, cs_details, device, **kw):
        seen.append(device)
        raise SystemExit(0)

    monkeypatch.setattr(nodes, "make_setup_node", fake_setup)
    monkeypatch.delenv("COFHE_DEVICE", raising=False)
    with pytest.raises(SystemExit):
        cli.main(["setup_node", "127.0.0.1", "1"])
    monkeypatch.setenv("COFHE_DEVICE", "host")
    with pytest.raises(SystemExit):
        cli.main(["setup_node", "127.0.0.1", "1"])
    assert seen == ["cuda", "host"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SetupNodeHandler(NodeDetails("127.0.0.1", "1", NodeType.SETUP_NODE),
                         CryptoSystemDetails("CoFHE_GPU", "", 128, 32, 2, 3))
