"""The deployments a configuration file describes, built on the program
(cofhe_tpu_torch). Each exposes the program's own entry objects, and an op
file (portbench/ops/<op>.py) drives whichever entry it needs:

* "local": one `api.CryptoSystem` in this process (the library a caller
  links): `cs`, `pk`, `sk`;
* "threshold": the node network in this process, each node an
  in-process server on loopback TCP: the setup node (the dealer, `setup`),
  the CoFHE nodes' handlers (`cofhe`), the compute node's (`compute`) and
  a `ClientNode` (`client`) that sends the requests, with the client's
  CryptoSystem as `cs` and `pk`, `sk`; `call` sends one ComputeRequest.

The secret key is drawn uniformly from the seed below the secret-key
bound, by the benchmark (the reference knows it without asking the
program); the dealer deals its shares once from a generator seeded by the
seed. Every deployment also has `encrypt` (set-up's pool), `hooks()`,
the program functions the traced run wraps in spans, by label, and
`engines()`, the TorchEngines whose counters the per-layer metrics read.
"""

from __future__ import annotations

import random
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def secret_key(seed: int, bound: int) -> int:
    """The deployment's secret key, uniform below `bound`, from the seed."""
    return random.Random(f"{seed}:secret-key").randrange(bound)


class Local:
    """The library deployment: one CryptoSystem on `cfg["device"]`."""

    kind = "local"

    def __init__(self, cfg: dict, seed: int, sk_bound: int):
        from cofhe_tpu_torch.api import CryptoSystem

        self.cs = CryptoSystem(cfg["security_level"], cfg["k"],
                               device=cfg["device"], p=int(cfg["p"], 16),
                               seed=f"portbench:{seed}".encode())
        self.sk = secret_key(seed, sk_bound)
        self.pk = self.cs.keygen(self.sk)

    def encrypt(self, values, shape):
        from cofhe_tpu_torch.tensor import Tensor

        return self.cs.encrypt_tensor(self.pk, Tensor(list(values), tuple(shape)))

    def engines(self) -> list:
        return [self.cs._engine]

    def hooks(self) -> dict:
        return {"part_decrypt": [(self.cs._engine, "part_decrypt_batch")]}

    def close(self) -> None:
        pass


class Threshold:
    """The node network: setup node, `cfg["total_nodes"]` CoFHE nodes and a
    compute node as in-process servers, and a client node."""

    kind = "threshold"

    def __init__(self, cfg: dict, seed: int, sk_bound: int):
        from cofhe_tpu_torch.core import liss
        from cofhe_tpu_torch.core.rng import RandGen
        from cofhe_tpu_torch.node import nodes
        from cofhe_tpu_torch.node.network_details import (CryptoSystemDetails,
                                                          NodeDetails, NodeType)
        from cofhe_tpu_torch.smpc.triplets import BeaversTripletGenerator

        t, n = cfg["threshold"], cfg["total_nodes"]
        self.servers, self.client, self.compute = [], None, None
        try:
            setup_nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.SETUP_NODE)
            details = CryptoSystemDetails(type="CoFHE_GPU", public_key="",
                                          security_level=cfg["security_level"],
                                          k=cfg["k"], threshold=t, total_nodes=n)
            server, setup = nodes.make_setup_node(setup_nd, details,
                                                  device=cfg["setup_device"])
            # the dealer's keys and shares from the seed, before any node joins
            setup.sk = secret_key(seed, sk_bound)
            setup.pk = setup.cs.keygen(setup.sk)
            details.public_key = setup.cs.serialize_public_key(setup.pk)
            setup.cs.rand_gen = RandGen(f"portbench:{seed}:shares".encode())
            setup.rank_shares = liss.rank_indexed_shares(setup.cs.keygen(setup.sk, t, n), n, t)
            setup.triplet_gen = BeaversTripletGenerator(setup.cs, setup.pk)
            self.setup = setup
            server.run_in_thread()
            self.servers.append(server)
            for dev in cfg["cofhe_devices"]:
                nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.COFHE_NODE)
                self.servers.append(nodes.make_cofhe_node(nd, setup_nd, device=dev))
                self.servers[-1].run_in_thread()
            nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.COMPUTE_NODE)
            self.servers.append(nodes.make_compute_node(nd, setup_nd,
                                                        device=cfg["compute_device"]))
            self.servers[-1].run_in_thread()
            self.cofhe = [s.handler.__self__ for s in self.servers[1:1 + n]]
            self.compute = self.servers[-1].handler.__self__
            self.client = nodes.ClientNode(setup_nd, use_tls=False,
                                           device=cfg["client_device"])
        except BaseException:
            self.close()
            raise
        self.cs, self.pk = self.client.crypto_system, self.client.public_key
        self.sk = setup.sk
        for h in self.cofhe + [self.compute]:
            if h.cs.hsm2k.p != int(cfg["p"], 16):
                raise RuntimeError("a node runs another discriminant than the "
                                   "configuration's p")

    def encrypt(self, values, shape):
        from cofhe_tpu_torch.tensor import Tensor

        return self.cs.encrypt_tensor(self.pk, Tensor(list(values), tuple(shape)))

    def call(self, op_type: str, op: str, operands) -> bytes:
        """Send one ComputeRequest (`op_type`, `op`: member names of the
        wire enums, e.g. "UNARY", "DECRYPT") from the client; the reply's
        data, or RuntimeError when the compute node refuses."""
        from cofhe_tpu_torch.node import wire

        resp = self.client.compute(wire.ComputeRequest(
            wire.ComputeOperationType[op_type], wire.ComputeOperation[op], list(operands)))
        if resp.status != wire.Status.OK:
            raise RuntimeError(f"the compute node refused {op}: {resp.data[:300]!r}")
        return resp.data

    def engines(self) -> list:
        return [h.cs._engine for h in self.cofhe + [self.compute]]

    def hooks(self) -> dict:
        from cofhe_tpu_torch import serialize as ser

        names = ("serialize_ciphertext_tensor", "deserialize_ciphertext_tensor",
                 "serialize_pdr_tensor", "deserialize_pdr_tensor",
                 "serialize_plaintext_tensor", "deserialize_plaintext_tensor")
        return {"part_decrypt": [(h.cs, "part_decrypt_tensor") for h in self.cofhe],
                "serialize": [(ser, name) for name in names]}

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        if self.compute is not None:
            self.compute.smpc.close()
        for s in self.servers:
            s.stop()


DEPLOYMENTS = {"local": Local, "threshold": Threshold}


def build(cfg: dict, seed: int, sk_bound: int):
    kind = cfg["deployment"]
    if kind not in DEPLOYMENTS:
        raise ValueError(f"unknown deployment {kind!r} (one of {sorted(DEPLOYMENTS)})")
    return DEPLOYMENTS[kind](cfg, seed, sk_bound)
