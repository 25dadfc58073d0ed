"""Node CLI: role dispatch like the reference `node` binary
(examples/node.cpp:14-82):

    python -m cofhe_tpu_torch.node.cli setup_node   <ip> <port> [options]
    python -m cofhe_tpu_torch.node.cli cofhe_node   <ip> <port> <setup_ip> <setup_port>
    python -m cofhe_tpu_torch.node.cli compute_node <ip> <port> <setup_ip> <setup_port>
    python -m cofhe_tpu_torch.node.cli client_node  <ip> <port> <setup_ip> <setup_port>

Defaults mirror examples/node.cpp:30-36: sec=128, k=256 (k=32 with --toy for
fast local runs), threshold=2, total CoFHE nodes=3. client_node performs one
ciphertext multiply + threshold decrypt and prints timings. `--device`
picks the node's engine: cuda (the default, or $COFHE_DEVICE), cpu (the
kernels' plain torch versions) or host (GMP). `--distributed
coordinator:port,nproc,pid` joins this process to a torch.distributed
process group first (parallel/distributed.py), as the JAX package's CLI
joins jax.distributed; the node's engine gets no mesh, as there. The
port's copy of cofhe_tpu/node/cli.py.
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cofhe-node")
    ap.add_argument("role", choices=["setup_node", "cofhe_node", "compute_node", "client_node"])
    ap.add_argument("ip")
    ap.add_argument("port")
    ap.add_argument("setup_ip", nargs="?", default="127.0.0.1")
    ap.add_argument("setup_port", nargs="?", default="4455")
    ap.add_argument("--security-level", type=int, default=128)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--threshold", type=int, default=2)
    ap.add_argument("--total-nodes", type=int, default=3)
    ap.add_argument("--cert", default=os.environ.get("COFHE_CERT"))
    ap.add_argument("--key", default=os.environ.get("COFHE_KEY"))
    ap.add_argument("--device", default=os.environ.get("COFHE_DEVICE", "cuda"),
                    choices=["cuda", "cpu", "host"])
    ap.add_argument("--distributed", default=None,
                    help="this node's ranks: coordinator:port,nproc,pid "
                         "(torch.distributed; nccl with a card, else gloo)")
    ap.add_argument("--toy", action="store_true", help="tiny parameters for local demos")
    ap.add_argument("--state", default=None,
                    help="setup-node checkpoint file (restore on restart)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.distributed:
        from ..parallel import distributed as dist

        dist.init(**dist.parse_flag(args.distributed))

    from .network_details import CryptoSystemDetails, NodeDetails, NodeType
    from . import nodes as node_factories

    if args.toy:
        args.k = 32

    self_node = NodeDetails(args.ip, args.port, NodeType.SETUP_NODE)
    setup_node = NodeDetails(args.setup_ip, args.setup_port, NodeType.SETUP_NODE)
    tls = dict(certfile=args.cert, keyfile=args.key)
    use_tls = args.cert is not None

    if args.role == "setup_node":
        cs_details = CryptoSystemDetails(
            type="CoFHE_GPU", public_key="", security_level=args.security_level,
            k=args.k, threshold=args.threshold, total_nodes=args.total_nodes)
        server, _handler = node_factories.make_setup_node(
            self_node, cs_details, device=args.device, state_path=args.state, **tls)
        print(f"setup node listening on {args.ip}:{args.port}", flush=True)
        server.run_forever()
    elif args.role == "cofhe_node":
        self_node = NodeDetails(args.ip, args.port, NodeType.COFHE_NODE)
        server = node_factories.make_cofhe_node(self_node, setup_node,
                                                device=args.device, **tls)
        print(f"cofhe node listening on {args.ip}:{args.port}", flush=True)
        server.run_forever()
    elif args.role == "compute_node":
        self_node = NodeDetails(args.ip, args.port, NodeType.COMPUTE_NODE)
        server = node_factories.make_compute_node(self_node, setup_node,
                                                  device=args.device, **tls)
        print(f"compute node listening on {args.ip}:{args.port}", flush=True)
        server.run_forever()
    else:  # client_node: one ct*ct multiply + decrypt with timings
        from . import wire

        client = node_factories.ClientNode(setup_node, use_tls=use_tls, device=args.device)
        cs, pk = client.crypto_system, client.public_key
        ct1 = cs.encrypt(pk, cs.make_plaintext(2.0))
        ct2 = cs.encrypt(pk, cs.make_plaintext(3.0))
        op = wire.ComputeRequest(
            wire.ComputeOperationType.BINARY, wire.ComputeOperation.MULTIPLY,
            [wire.ComputeOperand(wire.DataType.SINGLE, wire.DataEncryptionType.CIPHERTEXT,
                                 cs.serialize_ciphertext(ct1).encode()),
             wire.ComputeOperand(wire.DataType.SINGLE, wire.DataEncryptionType.CIPHERTEXT,
                                 cs.serialize_ciphertext(ct2).encode())])
        t0 = time.time()
        mul_resp = client.compute(op)
        t_mul = time.time() - t0
        ct_prod = cs.deserialize_ciphertext(mul_resp.data.decode())
        op2 = wire.ComputeRequest(
            wire.ComputeOperationType.UNARY, wire.ComputeOperation.DECRYPT,
            [wire.ComputeOperand(wire.DataType.SINGLE, wire.DataEncryptionType.CIPHERTEXT,
                                 cs.serialize_ciphertext(ct_prod).encode())])
        t0 = time.time()
        dec_resp = client.compute(op2)
        t_dec = time.time() - t0
        value = cs.get_float_from_plaintext(cs.deserialize_plaintext(dec_resp.data.decode()))
        print(f"2.0 * 3.0 = {value}")
        print(f"multiply: {t_mul * 1e6:.0f} us, decrypt: {t_dec * 1e6:.0f} us")
        client.close()


if __name__ == "__main__":
    main()
