"""Node factories + client node (reference node/nodes.hpp:15-70 and
node/client_node.hpp:19-72): construct servers with the right role handler;
CoFHE/compute nodes join via the setup node before serving.

The port's copy of cofhe_tpu/node/nodes.py: every factory and ClientNode
run the port's CryptoSystem on `device`, "cuda" by default."""

from __future__ import annotations

import logging
import ssl
import time

from .client import Client, make_client_ssl_context
from .handlers import CoFHENodeHandler, ComputeNodeHandler, SetupNodeHandler
from .network_details import (
    CryptoSystemDetails,
    NetworkDetails,
    NodeDetails,
    NodeType,
)
from .server import Server, make_server_ssl_context
from . import wire
from .wire import Request, Response, ServiceType, Status

log = logging.getLogger("cofhe_tpu_torch.node")


def _server_ssl(certfile: str | None, keyfile: str | None) -> ssl.SSLContext | None:
    if certfile and keyfile:
        return make_server_ssl_context(certfile, keyfile)
    return None


def make_setup_node(self_node: NodeDetails, cs_details: CryptoSystemDetails,
                    certfile: str | None = None, keyfile: str | None = None,
                    device: str = "cuda", state_path: str | None = None
                    ) -> tuple[Server, SetupNodeHandler]:
    handler = SetupNodeHandler(self_node, cs_details, device=device,
                               state_path=state_path)
    server = Server(self_node.ip, int(self_node.port), handler.handle,
                    _server_ssl(certfile, keyfile), role="setup")
    return server, handler


def _join(setup_node: NodeDetails, self_node: NodeDetails, join_type: wire.JoinType,
          use_tls: bool, retries: int = 20) -> wire.JoinAsNodeResponse:
    ssl_ctx = make_client_ssl_context() if use_tls else None
    client = Client(setup_node.ip, int(setup_node.port), ssl_ctx)
    jreq = wire.JoinAsNodeRequest(join_type, self_node.ip, self_node.port)
    req = Request(ServiceType.SETUP_REQUEST,
                  wire.SetupNodeRequest(wire.SetupRequestType.JOIN_AS_NODE_REQUEST,
                                        jreq.to_bytes()).to_bytes())
    last = None
    for _ in range(retries):
        try:
            resp = client.run(req)
            if resp.status == Status.OK:
                jresp = wire.JoinAsNodeResponse.from_bytes(resp.data)
                if jresp.status == Status.OK:
                    client.close()
                    return jresp
                last = jresp.error_message
        except (ConnectionError, OSError) as e:
            last = str(e)
        time.sleep(0.5)
    raise RuntimeError(f"failed to join network: {last}")


def _fetch_network_details(setup_node: NodeDetails, self_node: NodeDetails,
                           use_tls: bool) -> NetworkDetails:
    ssl_ctx = make_client_ssl_context() if use_tls else None
    client = Client(setup_node.ip, int(setup_node.port), ssl_ctx)
    resp = client.run(Request(
        ServiceType.SETUP_REQUEST,
        wire.SetupNodeRequest(wire.SetupRequestType.NETWORK_DETAILS_REQUEST, b"").to_bytes()))
    client.close()
    if resp.status != Status.OK:
        raise RuntimeError("failed to fetch network details")
    nd = NetworkDetails.from_string(resp.data.decode())
    nd.self_node = self_node
    return nd


def make_cofhe_node(self_node: NodeDetails, setup_node: NodeDetails,
                    certfile: str | None = None, keyfile: str | None = None,
                    device: str = "cuda") -> Server:
    use_tls = certfile is not None
    jresp = _join(setup_node, self_node, wire.JoinType.JOIN_AS_COFHE_NODE, use_tls)
    nd = _fetch_network_details(setup_node, self_node, use_tls)
    nd.self_node = NodeDetails(self_node.ip, self_node.port, NodeType.COFHE_NODE)
    nd.cryptosystem_details.public_key = jresp.public_key
    nd.secret_key_shares = jresp.secret_key_shares
    handler = CoFHENodeHandler(nd, device=device)
    return Server(self_node.ip, int(self_node.port), handler.handle,
                  _server_ssl(certfile, keyfile), role="cofhe")


def make_compute_node(self_node: NodeDetails, setup_node: NodeDetails,
                      certfile: str | None = None, keyfile: str | None = None,
                      device: str = "cuda") -> Server:
    use_tls = certfile is not None
    _join(setup_node, self_node, wire.JoinType.JOIN_AS_COMPUTE_NODE, use_tls)
    nd = _fetch_network_details(setup_node, self_node, use_tls)
    nd.self_node = NodeDetails(self_node.ip, self_node.port, NodeType.COMPUTE_NODE)
    handler = ComputeNodeHandler(nd, device=device, use_tls=use_tls)
    return Server(self_node.ip, int(self_node.port), handler.handle,
                  _server_ssl(certfile, keyfile), role="compute")


class ClientNode:
    """End-user client: fetches topology from the setup node and talks to
    the first compute node (client_node.hpp:41-72)."""

    def __init__(self, setup_node: NodeDetails, use_tls: bool = True,
                 device: str = "cuda", timeout: float | None = None):
        # compute requests at production params can run many minutes on a
        # small host (Beaver matmul = triplet refill + 2 threshold
        # decrypts); COFHE_CLIENT_TIMEOUT_S overrides the 120 s default
        import os as _os

        if timeout is None:
            timeout = float(_os.environ.get(
                "COFHE_CLIENT_TIMEOUT_S",
                _os.environ.get("COFHE_RPC_TIMEOUT", "120")))
        from ..api import CryptoSystem

        self.self_node = NodeDetails("127.0.0.1", "0", NodeType.CLIENT_NODE)
        self.nd = _fetch_network_details(setup_node, self.self_node, use_tls)
        compute_nodes = self.nd.compute_nodes()
        if not compute_nodes:
            raise RuntimeError("no compute node in the network")
        cd = self.nd.cryptosystem_details
        self.crypto_system = CryptoSystem(cd.security_level, cd.k, device=device)
        self.public_key = self.crypto_system.deserialize_public_key(cd.public_key)
        ssl_ctx = make_client_ssl_context() if use_tls else None
        self._client = Client(compute_nodes[0].ip, int(compute_nodes[0].port), ssl_ctx,
                              timeout=timeout)

    def compute(self, creq: wire.ComputeRequest) -> wire.ComputeResponse:
        resp = self._client.run(Request(ServiceType.COMPUTE_REQUEST, creq.to_bytes()))
        if resp.status != Status.OK:
            raise RuntimeError(f"compute request failed: {resp.data[:200]!r}")
        return wire.ComputeResponse.from_bytes(resp.data)

    def close(self):
        self._client.close()
