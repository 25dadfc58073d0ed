"""SMPCClient: the compute node's gateway to the threshold network
(reference smpc/smpc_client.hpp:21-296).

Holds persistent clients to `threshold` CoFHE nodes and the setup node, a
refillable Beaver-triplet cache, and the threshold-decrypt fan-out: send the
serialized ciphertext (tensor) to t nodes with the combination-rank
`sk_share_id`, collect partial decryptions, and combine locally. On
connection loss it refetches topology and recomputes the rank of the
surviving node combination (elastic recovery, smpc_client.hpp:232-295).

The port's copy of cofhe_tpu/smpc/client.py, bound to the port's
facade.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from ..core import liss
from ..tensor import Tensor
from ..node.client import Client, make_client_ssl_context
from ..node.network_details import NetworkDetails, NodeType
from ..node.wire import (
    BeaversTripletRequest,
    BeaversTripletResponse,
    CoFHENodeRequest,
    CoFHERequestType,
    DataType,
    PartialDecryptionRequest,
    PartialDecryptionResponse,
    Request,
    ServiceType,
    SetupNodeRequest,
    SetupRequestType,
    Status,
)

log = logging.getLogger("cofhe_tpu_torch.smpc")

# reference smpc_client.hpp:17 uses 10M; keep the default small enough to not
# swamp the python dealer, configurable for production via
# COFHE_TRIPLET_CACHE (a refill requests max(need, cache_size) triplets)
import os as _os

DEFAULT_TRIPLET_CACHE = int(_os.environ.get("COFHE_TRIPLET_CACHE", "1024"))


class SMPCClient:
    def __init__(self, network_details: NetworkDetails, crypto_system,
                 use_tls: bool = True, cache_size: int = DEFAULT_TRIPLET_CACHE):
        self.nd = network_details
        self.cs = crypto_system
        self.use_tls = use_tls
        self.cache_size = cache_size
        self.threshold = network_details.cryptosystem_details.threshold
        self._triplets: list = []
        self._triplet_lock = threading.Lock()
        self._setup_client: Client | None = None
        self._pd_clients: list[Client] = []
        self._combo: tuple[int, ...] = ()
        self._sk_share_id = 0
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="smpc")
        self._init_clients()

    # ------------------------------------------------------------ connections
    def _ssl(self):
        return make_client_ssl_context() if self.use_tls else None

    def _init_clients(self):
        setup = next(n for n in self.nd.nodes if n.type == NodeType.SETUP_NODE)
        self._setup_client = Client(setup.ip, int(setup.port), self._ssl())
        self._reinit_partial_decryption_clients()

    def _reinit_partial_decryption_clients(self):
        """Connect to the first `threshold` live CoFHE nodes and compute the
        lexicographic rank of that combination as sk_share_id
        (smpc_client.hpp:232-295)."""
        cofhe_nodes = self.nd.cofhe_nodes()
        live: list[int] = []
        clients: list[Client] = []
        for idx, node in enumerate(cofhe_nodes):
            if len(live) >= self.threshold:
                break
            cl = Client(node.ip, int(node.port), self._ssl())
            try:
                cl._connect()
            except OSError:
                log.warning("CoFHE node %s:%s unreachable", node.ip, node.port)
                continue
            live.append(idx)
            clients.append(cl)
        if len(live) < self.threshold:
            raise RuntimeError(
                f"only {len(live)} live CoFHE nodes, need threshold={self.threshold}")
        self._pd_clients = clients
        self._combo = tuple(live)
        n = self.nd.cryptosystem_details.total_nodes
        self._sk_share_id = liss.combination_rank(self._combo, n)

    def refresh_topology(self):
        resp = self._setup_client.run(Request(
            ServiceType.SETUP_REQUEST,
            SetupNodeRequest(SetupRequestType.NETWORK_DETAILS_REQUEST, b"").to_bytes()))
        if resp.status != Status.OK:
            raise RuntimeError("topology refresh failed")
        nd = NetworkDetails.from_string(resp.data.decode())
        nd.self_node = self.nd.self_node
        self.nd = nd
        self._reinit_partial_decryption_clients()

    # ------------------------------------------------------------- triplets
    def get_beavers_triplets(self, n: int) -> list:
        """Returns n (Enc(a), Enc(b), Enc(ab)) triplets, refilling the cache
        from the setup node as needed (smpc_client.hpp:61-114)."""
        with self._triplet_lock:
            if len(self._triplets) < n:
                need = max(n - len(self._triplets), self.cache_size)
                self._refill(need)
            out = self._triplets[:n]
            del self._triplets[:n]
            return out

    def _refill(self, count: int):
        req = Request(ServiceType.SETUP_REQUEST,
                      SetupNodeRequest(SetupRequestType.BEAVERS_TRIPLET_REQUEST,
                                       BeaversTripletRequest(count).to_bytes()).to_bytes())
        resp = self._setup_client.run(req)
        if resp.status != Status.OK:
            raise RuntimeError("beaver triplet refill failed")
        br = BeaversTripletResponse.from_bytes(resp.data)
        if br.status != Status.OK:
            raise RuntimeError("beaver triplet refill failed")
        tensor = self.cs.deserialize_ciphertext_tensor(br.data)
        n = tensor.shape[0]
        for i in range(n):
            self._triplets.append((tensor.at(i, 0), tensor.at(i, 1), tensor.at(i, 2)))

    # -------------------------------------------------------------- decrypt
    def _partial_decrypt_rpc(self, client: Client, payload: bytes, data_type: DataType) -> bytes:
        pd_req = PartialDecryptionRequest(self._sk_share_id, data_type, payload)
        req = Request(ServiceType.COFHE_REQUEST,
                      CoFHENodeRequest(CoFHERequestType.PARTIAL_DECRYPTION,
                                       pd_req.to_bytes()).to_bytes())
        resp = client.run(req)
        if resp.status != Status.OK:
            raise RuntimeError("partial decryption RPC failed")
        pd = PartialDecryptionResponse.from_bytes(resp.data)
        if pd.status != Status.OK:
            raise RuntimeError("partial decryption rejected")
        return pd.data

    def _fanout(self, payload: bytes, data_type: DataType) -> list[bytes]:
        """Threshold fan-out with elastic recovery: a node failing MID-fanout
        (not just before it) triggers a topology refresh + rank recompute and
        one retry against the surviving combination (the reference only
        reinits when connections were already short, smpc_client.hpp:118-121;
        here a failed RPC also drops the dead client first)."""
        if len(self._pd_clients) < self.threshold:
            self.refresh_topology()
        for attempt in (0, 1):
            futures = [self._pool.submit(self._partial_decrypt_rpc, cl,
                                         payload, data_type)
                       for cl in self._pd_clients]
            results, dead = [], []
            for cl, f in zip(self._pd_clients, futures):
                try:
                    results.append(f.result())
                except (OSError, RuntimeError) as e:
                    log.warning("partial-decryption RPC to %s:%s failed: %s",
                                cl.host, cl.port, e)
                    dead.append(cl)
            if not dead:
                return results
            if attempt == 0:
                for cl in dead:
                    try:
                        cl.close()
                    except OSError:
                        pass
                    if cl in self._pd_clients:
                        self._pd_clients.remove(cl)
                self.refresh_topology()
        raise RuntimeError("threshold fan-out failed after elastic reinit")

    def decrypt(self, ct) -> int:
        payload = self.cs.serialize_ciphertext(ct).encode()
        blobs = self._fanout(payload, DataType.SINGLE)
        pdrs = [self.cs.deserialize_part_decryption_result(b.decode()) for b in blobs]
        return self.cs.combine_part_decryption_results(ct, pdrs)

    def decrypt_tensor(self, ct: Tensor) -> Tensor:
        from .. import serialize as ser

        payload = ser.serialize_ciphertext_tensor(ct)
        blobs = self._fanout(payload, DataType.TENSOR)
        pdrs = [ser.deserialize_pdr_tensor(b) for b in blobs]
        return self.cs.combine_part_decryption_results_tensor(ct, pdrs)

    def close(self):
        for cl in self._pd_clients:
            cl.close()
        if self._setup_client:
            self._setup_client.close()
        self._pool.shutdown(wait=False)
