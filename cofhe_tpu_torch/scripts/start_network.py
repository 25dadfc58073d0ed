"""Spin up a local network of the port's nodes: 1 setup + 3 CoFHE + 1
compute node (the reference's scripts/start_network.sh topology, ports
base .. base + 4, 4455-4459 by default), then optionally run the demo
client. The port's copy of scripts/start_network.py.

    python -m cofhe_tpu_torch.scripts.start_network [--toy] [--tls]
        [--device cuda|cpu|host] [--base-port N] [--logdir DIR] [--client]

Nodes run as subprocesses (like the reference's nohup'd binaries), each
started once the one before it listens; logs go to --logdir (build/cofhe_net
in the checkout by default). With --client the demo client_node runs one
ciphertext multiply and threshold decrypt, and the network is torn down;
without it Ctrl-C tears the network down.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NODE_START_S = 300  # a node on the card sets up its engine before it listens


def wait_listening(port: int, proc: subprocess.Popen, timeout_s: float) -> None:
    """Wait until 127.0.0.1:port accepts a connection; raise if `proc`
    exits first or the time runs out."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"node on port {port} exited rc={proc.returncode}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.2)
    raise RuntimeError(f"node on port {port} did not listen within {timeout_s} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--toy", action="store_true")
    ap.add_argument("--tls", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu", "host"])
    ap.add_argument("--base-port", type=int, default=4455)
    ap.add_argument("--logdir", default=os.path.join(ROOT, "build", "cofhe_net"))
    ap.add_argument("--client", action="store_true", help="run the demo client then exit")
    args = ap.parse_args(argv)

    logdir = args.logdir
    os.makedirs(logdir, exist_ok=True)
    tls_args: list[str] = []
    if args.tls:
        cert, key = os.path.join(logdir, "server.pem"), os.path.join(logdir, "server_key.pem")
        if not os.path.exists(cert):
            subprocess.run(
                ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
                 "-out", cert, "-days", "365", "-nodes", "-subj", "/CN=localhost"],
                check=True, capture_output=True)
        tls_args = ["--cert", cert, "--key", key]

    common = (["--toy"] if args.toy else []) + ["--device", args.device] + tls_args
    base = args.base_port
    procs = []

    def launch(role, port):
        log = open(os.path.join(logdir, f"{role}_{port}.log"), "w")
        cmd = [sys.executable, "-m", "cofhe_tpu_torch.node.cli", role, "127.0.0.1",
               str(port), "127.0.0.1", str(base)] + common
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        procs.append(p)
        wait_listening(port, p, NODE_START_S)

    rc = 0
    try:
        launch("setup_node", base)
        for i in range(1, 4):
            launch("cofhe_node", base + i)
        launch("compute_node", base + 4)
        print(f"network up: setup={base}, cofhe={base + 1}..{base + 3}, "
              f"compute={base + 4}; logs in {logdir}/", flush=True)
        if args.client:
            rc = subprocess.run(
                [sys.executable, "-m", "cofhe_tpu_torch.node.cli", "client_node",
                 "127.0.0.1", "0", "127.0.0.1", str(base)] + common, cwd=ROOT).returncode
        else:
            while True:
                time.sleep(5)
                for p in procs:
                    if p.poll() is not None:
                        print(f"node pid {p.pid} exited rc={p.returncode}", file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
    return rc


if __name__ == "__main__":
    sys.exit(main())
