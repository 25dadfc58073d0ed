"""Role handlers: setup / CoFHE / compute node request dispatch.

Mirrors the reference handlers:
  * SetupNodeHandler   — setup_node_request_handler.hpp + join_as_node.hpp
                         + beavers_triplet_request_handler.hpp: threshold
                         keygen at construction (trusted dealer), join
                         protocol handing each CoFHE party its rank-indexed
                         share bundle, topology queries, triplet dealing.
  * CoFHENodeHandler   — cofhe_node_request_handler.hpp +
                         partial_decryption_request_handler.hpp: partial
                         decryption with the share selected by the wire
                         sk_share_id (combination rank).
  * ComputeNodeHandler — compute_request_handler.hpp: the eval-engine API
                         (UNARY DECRYPT; BINARY ADD/MULTIPLY over the four
                         plaintext/ciphertext operand combinations, ct*ct via
                         the Beaver multiplier, ct*pt via scal ops).

The port's copy of cofhe_tpu/node/handlers.py: every role builds the
port's CryptoSystem on `device`, "cuda" unless the caller asks for "cpu"
(plain torch kernels) or "host" (GMP).
"""

from __future__ import annotations

import logging
import threading

from .. import serialize as ser
from ..api import CryptoSystem
from ..core import liss
from ..tensor import Tensor
from .network_details import CryptoSystemDetails, NetworkDetails, NodeDetails, NodeType
from . import wire
from .wire import Request, Response, ServiceType, Status

log = logging.getLogger("cofhe_tpu_torch.node")


class SetupNodeHandler:
    def __init__(self, self_node: NodeDetails, cs_details: CryptoSystemDetails,
                 device: str = "cuda", state_path: str | None = None):
        self.self_node = self_node
        self.cs_details = cs_details
        self.cs = CryptoSystem(cs_details.security_level, cs_details.k, device=device)
        self.state_path = state_path
        self._lock = threading.Lock()
        self.nodes: list[NodeDetails] = [self_node]
        restored = False
        if state_path:
            from .checkpoint import load_setup_state

            restored = load_setup_state(self, state_path)
            if restored:
                log.info("setup node state restored from %s", state_path)
        if not restored:
            # trusted-dealer keygen (join_as_node.hpp:365-385)
            self.sk = self.cs.keygen()
            self.pk = self.cs.keygen(self.sk)
            self.cs_details.public_key = self.cs.serialize_public_key(self.pk)
            n, t = cs_details.total_nodes, cs_details.threshold
            party_shares = self.cs.keygen(self.sk, t, n)
            self.rank_shares = liss.rank_indexed_shares(party_shares, n, t)
            self._next_party = 0
            self._checkpoint()
        from ..smpc.triplets import BeaversTripletGenerator

        self.triplet_gen = BeaversTripletGenerator(self.cs, self.pk)

    def _checkpoint(self):
        if self.state_path:
            from .checkpoint import save_setup_state

            save_setup_state(self, self.state_path)

    # ------------------------------------------------------------------
    def network_details_for(self, requester: NodeDetails | None = None) -> NetworkDetails:
        return NetworkDetails(requester or self.self_node, list(self.nodes),
                              self.cs_details, [])

    def handle(self, req: Request) -> Response:
        sreq = wire.SetupNodeRequest.from_bytes(req.data)
        if sreq.request_type == wire.SetupRequestType.JOIN_AS_NODE_REQUEST:
            body = self._handle_join(wire.JoinAsNodeRequest.from_bytes(sreq.data))
        elif sreq.request_type == wire.SetupRequestType.BEAVERS_TRIPLET_REQUEST:
            body = self._handle_triplets(wire.BeaversTripletRequest.from_bytes(sreq.data))
        elif sreq.request_type == wire.SetupRequestType.NETWORK_DETAILS_REQUEST:
            body = self.network_details_for().to_string().encode()
        else:
            return Response(ServiceType.SETUP_REQUEST, Status.ERROR, b"unknown request")
        return Response(ServiceType.SETUP_REQUEST, Status.OK, body)

    def _handle_join(self, jreq: wire.JoinAsNodeRequest) -> bytes:
        with self._lock:
            if jreq.join_type == wire.JoinType.JOIN_AS_COFHE_NODE:
                if self._next_party >= self.cs_details.total_nodes:
                    return wire.JoinAsNodeResponse(
                        Status.ERROR, jreq.join_type,
                        error_message="network full").to_bytes()
                party = self._next_party
                self._next_party += 1
                self.nodes.append(NodeDetails(jreq.ip, jreq.port, NodeType.COFHE_NODE))
                self._checkpoint()
                shares = [str(s) for s in self.rank_shares[party]]
                return wire.JoinAsNodeResponse(
                    Status.OK, wire.JoinType.JOIN_AS_COFHE_NODE,
                    public_key=self.cs_details.public_key,
                    secret_key_shares=shares).to_bytes()
            else:
                self.nodes.append(NodeDetails(jreq.ip, jreq.port, NodeType.COMPUTE_NODE))
                self._checkpoint()
                return wire.JoinAsNodeResponse(
                    Status.OK, wire.JoinType.JOIN_AS_COMPUTE_NODE).to_bytes()

    def _handle_triplets(self, treq: wire.BeaversTripletRequest) -> bytes:
        tensor = self.triplet_gen.generate(treq.num_triples)
        data = ser.serialize_ciphertext_tensor(tensor)
        return wire.BeaversTripletResponse(Status.OK, data).to_bytes()


class CoFHENodeHandler:
    def __init__(self, network_details: NetworkDetails, device: str = "cuda"):
        self.nd = network_details
        cd = network_details.cryptosystem_details
        self.cs = CryptoSystem(cd.security_level, cd.k, device=device)
        self.pk = self.cs.deserialize_public_key(cd.public_key)
        self.sk_shares = [int(s) for s in network_details.secret_key_shares]

    def handle(self, req: Request) -> Response:
        creq = wire.CoFHENodeRequest.from_bytes(req.data)
        if creq.request_type != wire.CoFHERequestType.PARTIAL_DECRYPTION:
            return Response(ServiceType.COFHE_REQUEST, Status.ERROR, b"Not implemented")
        pd = wire.PartialDecryptionRequest.from_bytes(creq.data)
        if pd.sk_share_id >= len(self.sk_shares):
            return Response(ServiceType.COFHE_REQUEST, Status.ERROR, b"bad sk_share_id")
        share = self.sk_shares[pd.sk_share_id]
        if pd.data_type == wire.DataType.SINGLE:
            ct = self.cs.deserialize_ciphertext(pd.data.decode())
            out = self.cs.serialize_part_decryption_result(
                self.cs.part_decrypt(share, ct)).encode()
        elif pd.data_type == wire.DataType.TENSOR:
            ct = ser.deserialize_ciphertext_tensor(pd.data)
            out = ser.serialize_pdr_tensor(self.cs.part_decrypt_tensor(share, ct))
        else:
            return Response(ServiceType.COFHE_REQUEST, Status.ERROR, b"Not implemented")
        body = wire.PartialDecryptionResponse(Status.OK, out).to_bytes()
        return Response(ServiceType.COFHE_REQUEST, Status.OK, body)


class ComputeNodeHandler:
    def __init__(self, network_details: NetworkDetails, device: str = "cuda",
                 use_tls: bool = True):
        from ..smpc.client import SMPCClient
        from ..smpc.multiplier import SMPCCipherTextMultiplier

        self.nd = network_details
        cd = network_details.cryptosystem_details
        self.cs = CryptoSystem(cd.security_level, cd.k, device=device)
        self.pk = self.cs.deserialize_public_key(cd.public_key)
        self.smpc = SMPCClient(network_details, self.cs, use_tls=use_tls)
        self.multiplier = SMPCCipherTextMultiplier(self.smpc, self.pk)

    def handle(self, req: Request) -> Response:
        creq = wire.ComputeRequest.from_bytes(req.data)
        try:
            body = self._dispatch(creq)
            status = Status.OK
        except NotImplementedError as e:
            body, status = wire.ComputeResponse(Status.ERROR, str(e).encode()).to_bytes(), Status.OK
        except Exception as e:
            log.exception("compute error")
            body, status = wire.ComputeResponse(Status.ERROR, str(e).encode()).to_bytes(), Status.OK
        return Response(ServiceType.COMPUTE_REQUEST, status, body)

    # ------------------------------------------------------------------
    def _dispatch(self, creq: wire.ComputeRequest) -> bytes:
        op = creq.operation
        if creq.operation_type == wire.ComputeOperationType.UNARY:
            if op != wire.ComputeOperation.DECRYPT:
                raise NotImplementedError("Not implemented")
            return self._decrypt(creq.operands[0])
        if creq.operation_type != wire.ComputeOperationType.BINARY:
            raise NotImplementedError("Not implemented")
        if op == wire.ComputeOperation.ADD:
            return self._add(creq.operands)
        if op == wire.ComputeOperation.MULTIPLY:
            return self._multiply(creq.operands)
        raise NotImplementedError("Not implemented")

    def _ok(self, data: bytes) -> bytes:
        return wire.ComputeResponse(Status.OK, data).to_bytes()

    def _decrypt(self, operand: wire.ComputeOperand) -> bytes:
        if operand.encryption_type != wire.DataEncryptionType.CIPHERTEXT:
            raise ValueError("decrypt requires a ciphertext operand")
        if operand.data_type == wire.DataType.SINGLE:
            ct = self.cs.deserialize_ciphertext(operand.data.decode())
            return self._ok(self.cs.serialize_plaintext(self.smpc.decrypt(ct)).encode())
        if operand.data_type == wire.DataType.TENSOR:
            ct = ser.deserialize_ciphertext_tensor(operand.data)
            pt = self.smpc.decrypt_tensor(ct)
            return self._ok(ser.serialize_plaintext_tensor(pt))
        raise NotImplementedError("Not implemented")

    def _add(self, ops: list[wire.ComputeOperand]) -> bytes:
        o1, o2 = ops
        CT = wire.DataEncryptionType.CIPHERTEXT
        single = o1.data_type == wire.DataType.SINGLE
        if single:
            a = self._load_single_as_ct(o1)
            b = self._load_single_as_ct(o2)
            res = self.cs.add_ciphertexts(self.pk, a, b)
            return self._ok(self.cs.serialize_ciphertext(res).encode())
        a = self._load_tensor_as_ct(o1)
        b = self._load_tensor_as_ct(o2)
        res = self.cs.add_ciphertext_tensors(self.pk, a, b)
        return self._ok(ser.serialize_ciphertext_tensor(res))

    def _load_single_as_ct(self, o: wire.ComputeOperand):
        if o.encryption_type == wire.DataEncryptionType.CIPHERTEXT:
            return self.cs.deserialize_ciphertext(o.data.decode())
        pt = self.cs.deserialize_plaintext(o.data.decode())
        return self.cs.encrypt(self.pk, pt)

    def _load_tensor_as_ct(self, o: wire.ComputeOperand) -> Tensor:
        if o.encryption_type == wire.DataEncryptionType.CIPHERTEXT:
            return ser.deserialize_ciphertext_tensor(o.data)
        pt = ser.deserialize_plaintext_tensor(o.data)
        return self.cs.encrypt_tensor(self.pk, pt)

    def _multiply(self, ops: list[wire.ComputeOperand]) -> bytes:
        o1, o2 = ops
        CT = wire.DataEncryptionType.CIPHERTEXT
        PT = wire.DataEncryptionType.PLAINTEXT
        single = o1.data_type == wire.DataType.SINGLE
        if single:
            if o1.encryption_type == CT and o2.encryption_type == CT:
                res = self.multiplier.multiply_ciphertexts(
                    self.cs.deserialize_ciphertext(o1.data.decode()),
                    self.cs.deserialize_ciphertext(o2.data.decode()))
            elif o1.encryption_type == PT and o2.encryption_type == PT:
                res = self.cs.encrypt(self.pk, self.cs.multiply_plaintexts(
                    self.cs.deserialize_plaintext(o1.data.decode()),
                    self.cs.deserialize_plaintext(o2.data.decode())))
            else:
                ct_o, pt_o = (o1, o2) if o1.encryption_type == CT else (o2, o1)
                res = self.cs.scal_ciphertext(
                    self.pk, self.cs.deserialize_plaintext(pt_o.data.decode()),
                    self.cs.deserialize_ciphertext(ct_o.data.decode()))
            return self._ok(self.cs.serialize_ciphertext(res).encode())
        # tensors
        if o1.encryption_type == CT and o2.encryption_type == CT:
            res = self.multiplier.multiply_ciphertext_tensors(
                ser.deserialize_ciphertext_tensor(o1.data),
                ser.deserialize_ciphertext_tensor(o2.data))
        elif o1.encryption_type == PT and o2.encryption_type == PT:
            res = self.cs.encrypt_tensor(self.pk, self.cs.multiply_plaintext_tensors(
                ser.deserialize_plaintext_tensor(o1.data),
                ser.deserialize_plaintext_tensor(o2.data)))
        else:
            # ct (n,m) x pt (m,p) homomorphic matmul (either operand order)
            ct_o, pt_o = (o1, o2) if o1.encryption_type == CT else (o2, o1)
            res = self.cs.scal_ciphertext_tensors(
                self.pk, ser.deserialize_plaintext_tensor(pt_o.data),
                ser.deserialize_ciphertext_tensor(ct_o.data))
        return self._ok(ser.serialize_ciphertext_tensor(res))
