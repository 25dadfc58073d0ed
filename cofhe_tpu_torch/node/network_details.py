"""Network topology / cryptosystem configuration object.

JSON-schema-compatible with the reference `NetworkDetails`
(node/network_details.hpp:113-219): self_node{ip,port,type}, nodes[],
cryptosystem_details{type, public_key, security_level, k, threshold,
total_nodes}, secret_key_shares[]. A CoFHE node must hold exactly C(n, t)
shares (one per threshold combination containing it).

The port's copy of cofhe_tpu/node/network_details.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from math import comb


class NodeType(Enum):
    SETUP_NODE = "SETUP_NODE"
    COFHE_NODE = "CoFHE_NODE"
    COMPUTE_NODE = "COMPUTE_NODE"
    CLIENT_NODE = "CLIENT_NODE"


_NODE_TYPE_STRINGS = {
    NodeType.SETUP_NODE: "SETUP_NODE",
    NodeType.COFHE_NODE: "CoFHE_NODE",
    NodeType.COMPUTE_NODE: "COMPUTE_NODE",
    NodeType.CLIENT_NODE: "CLIENT_NODE",
}
_STRING_NODE_TYPES = {v: k for k, v in _NODE_TYPE_STRINGS.items()}


@dataclass
class NodeDetails:
    ip: str
    port: str
    type: NodeType

    def address(self) -> tuple[str, int]:
        return self.ip, int(self.port)


@dataclass
class CryptoSystemDetails:
    type: str  # "CoFHE_CPU" in the reference; "CoFHE_TPU" / "CoFHE_GPU" here
    public_key: str
    security_level: int
    k: int
    threshold: int
    total_nodes: int


@dataclass
class NetworkDetails:
    self_node: NodeDetails
    nodes: list[NodeDetails] = field(default_factory=list)
    cryptosystem_details: CryptoSystemDetails | None = None
    secret_key_shares: list[str] = field(default_factory=list)

    def __post_init__(self):
        if (self.self_node.type == NodeType.COFHE_NODE and self.cryptosystem_details
                and self.secret_key_shares):
            # The wire `sk_share_id` is the lexicographic rank of the
            # surviving threshold combination (reference smpc_client.hpp:
            # 283-295), so each CoFHE node stores a C(n, t)-long rank-indexed
            # share list (entries for combinations not containing the node
            # are unused placeholders). Mirrors network_details.hpp:119-125.
            n = self.cryptosystem_details.total_nodes
            t = self.cryptosystem_details.threshold
            if len(self.secret_key_shares) != comb(n, t):
                raise ValueError("invalid number of secret key shares")

    def cofhe_nodes(self) -> list[NodeDetails]:
        return [n for n in self.nodes if n.type == NodeType.COFHE_NODE]

    def compute_nodes(self) -> list[NodeDetails]:
        return [n for n in self.nodes if n.type == NodeType.COMPUTE_NODE]

    def to_json(self) -> dict:
        j: dict = {
            "self_node": {"ip": self.self_node.ip, "port": self.self_node.port,
                          "type": _NODE_TYPE_STRINGS[self.self_node.type]},
            "nodes": [{"ip": n.ip, "port": n.port, "type": _NODE_TYPE_STRINGS[n.type]}
                      for n in self.nodes],
        }
        cs = self.cryptosystem_details
        if cs is not None:
            j["cryptosystem_details"] = {
                "type": cs.type, "public_key": cs.public_key,
                "security_level": cs.security_level, "k": cs.k,
                "threshold": cs.threshold, "total_nodes": cs.total_nodes,
            }
        j["secret_key_shares"] = list(self.secret_key_shares)
        return j

    def to_string(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_string(data: str) -> "NetworkDetails":
        j = json.loads(data)
        self_node = NodeDetails(j["self_node"]["ip"], str(j["self_node"]["port"]),
                                _STRING_NODE_TYPES[j["self_node"]["type"]])
        nodes = [NodeDetails(n["ip"], str(n["port"]), _STRING_NODE_TYPES[n["type"]])
                 for n in j.get("nodes", [])]
        cs = None
        if "cryptosystem_details" in j:
            c = j["cryptosystem_details"]
            cs = CryptoSystemDetails(c["type"], c["public_key"], int(c["security_level"]),
                                     int(c["k"]), int(c["threshold"]), int(c["total_nodes"]))
        shares = [str(s) for s in j.get("secret_key_shares", [])]
        return NetworkDetails(self_node, nodes, cs, shares)

    @staticmethod
    def from_file(path: str) -> "NetworkDetails":
        with open(path) as f:
            return NetworkDetails.from_string(f.read())

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_string())
