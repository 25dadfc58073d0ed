"""Wire protocol: byte-compatible with the reference's framing.

Outer framing (node/request_response.hpp:111-362): one ASCII header line then
raw bytes —
    request:  "<ver> <service_type> <size>\n" + body
    response: "<ver> <service_type> <status> <size>\n" + body
ServiceType: 0=COMPUTE_REQUEST, 1=COFHE_REQUEST, 2=SETUP_REQUEST
(request_response.hpp:33-52). Status: 0=OK, 1=ERROR.

Inner payloads (each a small header line + data):
  * ComputeRequest (compute_request_handler.hpp:57-217):
      "<op_type> <op> <num_operands>\n" then per operand
      "<data_type> <enc_type> <size>\n" + data + "\n"
  * ComputeResponse: "<status> <size>\n" + data
  * CoFHENodeRequest (cofhe_node_request_handler.hpp:89-165):
      "<req_type> <size>\n" + data ; req_type 0=PartialDecryption, 1=SMPC
  * PartialDecryptionRequest (partial_decryption_request_handler.hpp:52-98):
      "<sk_share_id> <data_type> <size>\n" + data
  * SetupNodeRequest (setup_node_request_handler.hpp:95-135):
      "<req_type> <size>\n" + data ; 0=BEAVERS_TRIPLET, 1=JOIN_AS_NODE,
      2=NetworkDetails
  * JoinAsNodeRequest (join_as_node.hpp): "<join_type> <size>\n<ip> <port>"
  * JoinAsNodeResponse: "<status> <resp_type> <size>\n<pk>\n<share>\n..."
  * BeaversTripletRequest (beavers_triplet_request_handler.hpp:54-79):
      "<num_triples>"

The port's copy of cofhe_tpu/node/wire.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum


class ServiceType(IntEnum):
    COMPUTE_REQUEST = 0
    COFHE_REQUEST = 1
    SETUP_REQUEST = 2


class Status(IntEnum):
    OK = 0
    ERROR = 1


@dataclass
class Request:
    service_type: ServiceType
    data: bytes
    version: int = 0  # ProtocolVersion::V1

    def header_bytes(self) -> bytes:
        return f"{self.version} {int(self.service_type)} {len(self.data)}\n".encode()

    def to_bytes(self) -> bytes:
        return self.header_bytes() + self.data

    @staticmethod
    def parse_header(line: bytes) -> tuple[int, ServiceType, int]:
        ver, typ, size = line.decode().split()
        return int(ver), ServiceType(int(typ)), int(size)


@dataclass
class Response:
    service_type: ServiceType
    status: Status
    data: bytes
    version: int = 0

    def header_bytes(self) -> bytes:
        return f"{self.version} {int(self.service_type)} {int(self.status)} {len(self.data)}\n".encode()

    def to_bytes(self) -> bytes:
        return self.header_bytes() + self.data

    @staticmethod
    def parse_header(line: bytes) -> tuple[int, ServiceType, Status, int]:
        ver, typ, status, size = line.decode().split()
        return int(ver), ServiceType(int(typ)), Status(int(status)), int(size)


def _split_header(payload: bytes) -> tuple[str, bytes]:
    idx = payload.index(b"\n")
    return payload[:idx].decode(), payload[idx + 1:]


# --------------------------------------------------------------------- compute

class ComputeOperationType(IntEnum):
    UNARY = 0
    BINARY = 1
    TERNARY = 2


class ComputeOperation(IntEnum):
    DECRYPT = 0
    ADD = 1
    SUBTRACT = 2
    MULTIPLY = 3
    DIVIDE = 4


class DataType(IntEnum):
    SINGLE = 0
    TENSOR = 1
    TENSOR_ID = 2


class DataEncryptionType(IntEnum):
    PLAINTEXT = 0
    CIPHERTEXT = 1


@dataclass
class ComputeOperand:
    data_type: DataType
    encryption_type: DataEncryptionType
    data: bytes

    def to_bytes(self) -> bytes:
        return (f"{int(self.data_type)} {int(self.encryption_type)} {len(self.data)}\n".encode()
                + self.data + b"\n")


@dataclass
class ComputeRequest:
    operation_type: ComputeOperationType
    operation: ComputeOperation
    operands: list[ComputeOperand] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        out = f"{int(self.operation_type)} {int(self.operation)} {len(self.operands)}\n".encode()
        for op in self.operands:
            out += op.to_bytes()
        return out

    @staticmethod
    def from_bytes(payload: bytes) -> "ComputeRequest":
        header, rest = _split_header(payload)
        op_type, op, num = (int(x) for x in header.split())
        operands = []
        for _ in range(num):
            h, rest = _split_header(rest)
            dt, et, size = (int(x) for x in h.split())
            data = rest[:size]
            if len(data) != size:
                raise ValueError("operand data size mismatch")
            rest = rest[size:]
            while rest[:1] in (b"\n", b"\r"):
                rest = rest[1:]
            operands.append(ComputeOperand(DataType(dt), DataEncryptionType(et), data))
        return ComputeRequest(ComputeOperationType(op_type), ComputeOperation(op), operands)


@dataclass
class ComputeResponse:
    status: Status
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.status)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "ComputeResponse":
        header, rest = _split_header(payload)
        status, size = (int(x) for x in header.split())
        if len(rest) != size:
            raise ValueError("response data size mismatch")
        return ComputeResponse(Status(status), rest)


# ----------------------------------------------------------------- cofhe node

class CoFHERequestType(IntEnum):
    PARTIAL_DECRYPTION = 0
    SMPC = 1


@dataclass
class CoFHENodeRequest:
    request_type: CoFHERequestType
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.request_type)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "CoFHENodeRequest":
        header, rest = _split_header(payload)
        typ, size = (int(x) for x in header.split())
        return CoFHENodeRequest(CoFHERequestType(typ), rest[:size])


@dataclass
class CoFHENodeResponse:
    status: Status
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.status)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "CoFHENodeResponse":
        header, rest = _split_header(payload)
        status, size = (int(x) for x in header.split())
        return CoFHENodeResponse(Status(status), rest[:size])


@dataclass
class PartialDecryptionRequest:
    sk_share_id: int
    data_type: DataType
    data: bytes

    def to_bytes(self) -> bytes:
        return (f"{self.sk_share_id} {int(self.data_type)} {len(self.data)}\n".encode()
                + self.data)

    @staticmethod
    def from_bytes(payload: bytes) -> "PartialDecryptionRequest":
        header, rest = _split_header(payload)
        share_id, dt, size = (int(x) for x in header.split())
        return PartialDecryptionRequest(share_id, DataType(dt), rest[:size])


@dataclass
class PartialDecryptionResponse:
    status: Status
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.status)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "PartialDecryptionResponse":
        header, rest = _split_header(payload)
        status, size = (int(x) for x in header.split())
        return PartialDecryptionResponse(Status(status), rest[:size])


# ----------------------------------------------------------------- setup node

class SetupRequestType(IntEnum):
    BEAVERS_TRIPLET_REQUEST = 0
    JOIN_AS_NODE_REQUEST = 1
    NETWORK_DETAILS_REQUEST = 2


@dataclass
class SetupNodeRequest:
    request_type: SetupRequestType
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.request_type)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "SetupNodeRequest":
        header, rest = _split_header(payload)
        typ, size = (int(x) for x in header.split())
        return SetupNodeRequest(SetupRequestType(typ), rest[:size])


@dataclass
class SetupNodeResponse:
    status: Status
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.status)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "SetupNodeResponse":
        header, rest = _split_header(payload)
        status, size = (int(x) for x in header.split())
        return SetupNodeResponse(Status(status), rest[:size])


class JoinType(IntEnum):
    JOIN_AS_COFHE_NODE = 0
    JOIN_AS_COMPUTE_NODE = 1


@dataclass
class JoinAsNodeRequest:
    join_type: JoinType
    ip: str
    port: str

    def to_bytes(self) -> bytes:
        # declared size is ip.size()+1+port.size()+1 = len(body)+1 — one more
        # than the bytes actually written ("ip port"), a reference quirk its
        # ctor VALIDATES (join_as_node.hpp:224-230, 231); match it exactly
        body = f"{self.ip} {self.port}"
        return f"{int(self.join_type)} {len(body) + 1}\n".encode() + body.encode()

    @staticmethod
    def from_bytes(payload: bytes) -> "JoinAsNodeRequest":
        header, rest = _split_header(payload)
        typ, size = (int(x) for x in header.split())
        ip, port = rest.decode().split()
        if size != len(ip) + 1 + len(port) + 1:
            raise ValueError("Data size mismatch")  # join_as_node.hpp:226-229
        return JoinAsNodeRequest(JoinType(typ), ip, port)


@dataclass
class JoinAsNodeResponse:
    status: Status
    join_type: JoinType
    public_key: str = ""
    secret_key_shares: list[str] = field(default_factory=list)
    error_message: str = ""

    def to_bytes(self) -> bytes:
        if self.status == Status.ERROR:
            body = self.error_message + "\n"
        elif self.join_type == JoinType.JOIN_AS_COFHE_NODE:
            body = self.public_key + "\n"
            for share in self.secret_key_shares:
                body += share + "\n"
        else:
            body = ""
        return (f"{int(self.status)} {int(self.join_type)} {len(body)}\n".encode()
                + body.encode())

    @staticmethod
    def from_bytes(payload: bytes) -> "JoinAsNodeResponse":
        header, rest = _split_header(payload)
        status, typ, _size = (int(x) for x in header.split())
        status = Status(status)
        typ = JoinType(typ)
        if status == Status.ERROR:
            return JoinAsNodeResponse(status, typ, error_message=rest.decode().strip())
        if typ == JoinType.JOIN_AS_COFHE_NODE:
            lines = rest.decode().split("\n")
            lines = [l for l in lines if l]
            return JoinAsNodeResponse(status, typ, public_key=lines[0],
                                      secret_key_shares=lines[1:])
        return JoinAsNodeResponse(status, typ)


@dataclass
class BeaversTripletRequest:
    num_triples: int

    def to_bytes(self) -> bytes:
        return str(self.num_triples).encode()

    @staticmethod
    def from_bytes(payload: bytes) -> "BeaversTripletRequest":
        return BeaversTripletRequest(int(payload.decode().split()[0]))


@dataclass
class BeaversTripletResponse:
    status: Status
    data: bytes

    def to_bytes(self) -> bytes:
        return f"{int(self.status)} {len(self.data)}\n".encode() + self.data

    @staticmethod
    def from_bytes(payload: bytes) -> "BeaversTripletResponse":
        header, rest = _split_header(payload)
        status, size = (int(x) for x in header.split())
        return BeaversTripletResponse(Status(status), rest[:size])
