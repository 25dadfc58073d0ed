"""Checkpoint / resume for the setup node (an aux subsystem the reference
lacks entirely — SURVEY.md §5: a setup-node restart there regenerates keys
and orphans the network).

Persists the trusted-dealer state (secret key, public key, rank-indexed
share table, registered nodes, cryptosystem details) as JSON; a restarted
setup node restores it and the existing CoFHE/compute nodes keep working.

The port's copy of cofhe_tpu/node/checkpoint.py.
"""

from __future__ import annotations

import json
import os
import tempfile

from .network_details import CryptoSystemDetails, NodeDetails, NodeType


def save_setup_state(handler, path: str) -> None:
    """Snapshot a SetupNodeHandler. Atomic write (tmp + rename)."""
    state = {
        "version": 1,
        "cs_details": {
            "type": handler.cs_details.type,
            "public_key": handler.cs_details.public_key,
            "security_level": handler.cs_details.security_level,
            "k": handler.cs_details.k,
            "threshold": handler.cs_details.threshold,
            "total_nodes": handler.cs_details.total_nodes,
        },
        "sk": str(handler.sk),
        "rank_shares": [[str(s) for s in row] for row in handler.rank_shares],
        "next_party": handler._next_party,
        "nodes": [{"ip": n.ip, "port": n.port, "type": n.type.name}
                  for n in handler.nodes],
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".cofhe_ckpt_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_setup_state(handler, path: str) -> bool:
    """Restore a SetupNodeHandler from a snapshot; returns False if absent.
    The handler must have been constructed with the same (sec, k, t, n)."""
    if not os.path.exists(path):
        return False
    with open(path) as f:
        state = json.load(f)
    cd = state["cs_details"]
    if (cd["security_level"] != handler.cs_details.security_level
            or cd["k"] != handler.cs_details.k
            or cd["threshold"] != handler.cs_details.threshold
            or cd["total_nodes"] != handler.cs_details.total_nodes):
        raise ValueError("checkpoint cryptosystem parameters do not match")
    handler.sk = int(state["sk"])
    handler.pk = handler.cs.keygen(handler.sk)
    handler.cs_details.public_key = cd["public_key"]
    handler.rank_shares = [[int(s) for s in row] for row in state["rank_shares"]]
    handler._next_party = int(state["next_party"])
    handler.nodes = [NodeDetails(n["ip"], n["port"], NodeType[n["type"]])
                     for n in state["nodes"]]
    return True
