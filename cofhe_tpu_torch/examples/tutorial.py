"""End-to-end client tutorial (the reference's examples/tutorial.cpp), the
port's copy of examples/tutorial.py: encrypt float tensors, send a
homomorphic matmul to the compute node, threshold-decrypt over the network,
print the result.

Run a network first:  python -m cofhe_tpu_torch.scripts.start_network --toy
Then:                 python -m cofhe_tpu_torch.examples.tutorial --toy

`--device` picks the client's engine: cuda (the default), cpu (the kernels'
plain torch versions) or host (GMP).
"""

from __future__ import annotations

import argparse
import random
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--setup-ip", default="127.0.0.1")
    ap.add_argument("--setup-port", default="4455")
    ap.add_argument("--size", type=int, default=8)
    ap.add_argument("--tls", action="store_true")
    ap.add_argument("--toy", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu", "host"])
    args = ap.parse_args(argv)
    if args.toy:
        args.size = 4

    from .. import serialize as ser
    from ..node import wire
    from ..node.network_details import NodeDetails, NodeType
    from ..node.nodes import ClientNode
    from ..tensor import Tensor

    n = args.size
    random.seed(7)
    setup = NodeDetails(args.setup_ip, args.setup_port, NodeType.SETUP_NODE)
    client = ClientNode(setup, use_tls=args.tls, device=args.device)
    cs, pk = client.crypto_system, client.public_key

    xs = [[float(random.randrange(10)) for _ in range(n)] for _ in range(n)]
    ws = [[float(random.randrange(10)) for _ in range(n)] for _ in range(n)]
    print("encrypting", n, "x", n, "tensor...")
    ct = cs.encrypt_tensor(pk, Tensor(
        [cs.make_plaintext(v) for row in xs for v in row], (n, n)))
    w = Tensor([cs.make_plaintext(v) for row in ws for v in row], (n, n))

    print("requesting homomorphic matmul...")
    resp = client.compute(wire.ComputeRequest(
        wire.ComputeOperationType.BINARY, wire.ComputeOperation.MULTIPLY,
        [wire.ComputeOperand(wire.DataType.TENSOR, wire.DataEncryptionType.CIPHERTEXT,
                             ser.serialize_ciphertext_tensor(ct)),
         wire.ComputeOperand(wire.DataType.TENSOR, wire.DataEncryptionType.PLAINTEXT,
                             ser.serialize_plaintext_tensor(w))]))
    prod = ser.deserialize_ciphertext_tensor(resp.data)

    print("requesting threshold decryption...")
    dec = client.compute(wire.ComputeRequest(
        wire.ComputeOperationType.UNARY, wire.ComputeOperation.DECRYPT,
        [wire.ComputeOperand(wire.DataType.TENSOR, wire.DataEncryptionType.CIPHERTEXT,
                             ser.serialize_ciphertext_tensor(prod))]))
    out = ser.deserialize_plaintext_tensor(dec.data)

    ok = True
    for i in range(n):
        row = []
        for k in range(n):
            got = cs.get_float_from_plaintext(out.at(i, k))
            want = sum(xs[i][j] * ws[j][k] for j in range(n))
            ok &= got == want
            row.append(got)
        print(row)
    print("matches plaintext matmul:", ok)
    client.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
