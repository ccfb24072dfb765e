"""
llh server: serve compiled-template likelihood evaluations over TCP
(counterpart of ``pisa_tpu/utils/llh_server.py``; cf. reference
``pisa/utils/llh_server.py``: 4-byte big-endian length header + pickled
payload; clients send rescaled free-param vectors and receive the scalar
llh).

This exists for wire-protocol parity with the reference's emcee workflow.
The port's own samplers do not need it:
:func:`pisa_tpu_torch.analysis.bayesian.mcmc_sampling` evaluates all
walkers as lanes of one program on the device, without sockets or
processes.

A server over one pipeline serves its compiled objective: on a CUDA device
the objective is captured once, and a request copies the rescaled vector
to the card, replays the graph and reads one scalar back. A server over
several pipelines evaluates the eager ``DistributionMaker`` route. The
route follows from the configuration alone: a compile that fails raises.
"""

from __future__ import annotations

import multiprocessing
import pickle
import socketserver
import struct

import numpy as np

__all__ = [
    "ConnectionClosed",
    "send_obj",
    "receive_obj",
    "serve",
    "fork_servers",
    "main",
]

DFLT_HOST = "localhost"
DFLT_PORT = 9000
DFLT_NUM_SERVERS = multiprocessing.cpu_count()


class ConnectionClosed(Exception):
    """Connection closed."""


def send_obj(obj, sock):
    """Send a pickled object with a 4-byte big-endian length header
    (cf. reference ``llh_server.py:64``)."""
    payload = pickle.dumps(obj)
    sock.sendall(struct.pack("!i", len(payload)))
    sock.sendall(payload)


def _receive_exactly(sock, size):
    chunks = []
    received = 0
    while received < size:
        chunk = sock.recv(size - received)
        if len(chunk) == 0:
            raise ConnectionClosed()
        chunks.append(chunk)
        received += len(chunk)
    return b"".join(chunks)


def receive_obj(sock):
    """Receive an object framed by :func:`send_obj`
    (cf. reference ``llh_server.py:88``)."""
    (payload_size,) = struct.unpack("!i", _receive_exactly(sock, 4))
    return pickle.loads(_receive_exactly(sock, payload_size))


def llh_function(dm, ref_dist, metric):
    """``x -> llh`` (a float) at the rescaled free-param vector `x` of the
    DistributionMaker `dm` against the MapSet `ref_dist` under `metric`:
    the sign of a maximized llh. One pipeline: minus its compiled
    objective (built, and on a CUDA device captured, here). Several
    pipelines: the eager route, ``dm.get_outputs(return_sum=True)``."""
    from pisa_tpu_torch.utils import stats

    if len(dm.pipelines) == 1:
        ct = dm.pipelines[0].compile()
        value_only, _ = ct.build_objective(ref_dist, metric)

        def llh(x):
            # objective is minimized => llh = -objective for llh metrics
            return -float(value_only(np.asarray(x, dtype=np.float64)))

        return llh

    sign = -1.0 if not stats.is_metric_to_maximize(metric) else 1.0

    def llh(x):
        dm._set_rescaled_free_params(np.asarray(x, dtype=np.float64))
        hypo = dm.get_outputs(return_sum=True)
        return sign * float(ref_dist.metric_total(hypo, metric))

    return llh


class _Server(socketserver.TCPServer):
    allow_reuse_address = True


def serve(config, ref, port=DFLT_PORT, metric="llh", host=DFLT_HOST,
          device="cuda"):
    """Run a server evaluating the llh of `config`'s pipeline(s) on
    `device` against the reference map(s) at `ref` (cf. reference
    ``llh_server.py:serve``; the route: :func:`llh_function`). Blocks
    forever.

    Parameters
    ----------
    config : str or list — pipeline config path(s)
    ref : str or MapSet — reference (data) distribution (json path or MapSet)
    port : int
    metric : str — llh-family metric to serve (sign as maximized llh)
    device : torch.device or str — where the pipelines run
    """
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.map import MapSet

    dm = DistributionMaker(
        [config] if isinstance(config, str) else list(config), device=device
    )
    ref_dist = MapSet.from_json(ref) if isinstance(ref, str) else ref
    llh = llh_function(dm, ref_dist, metric)

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    x = receive_obj(self.request)
                except (ConnectionClosed, ConnectionResetError):
                    return
                send_obj(llh(x), self.request)

    with _Server((host, int(port)), Handler) as server:
        server.serve_forever()


def fork_servers(config, ref, port=DFLT_PORT, num=DFLT_NUM_SERVERS, **kw):
    """Start `num` server processes on consecutive ports (cf. reference
    ``llh_server.py:fork_servers``). They are spawned, not forked: a
    forked child cannot use CUDA once its parent has, so every argument
    must pickle (config paths, a ref path or MapSet). With the compiled
    template a single server usually suffices; this exists for parity."""
    ctx = multiprocessing.get_context("spawn")
    processes = []
    for i in range(num):
        p = ctx.Process(
            target=serve,
            kwargs=dict(config=config, ref=ref, port=int(port) + i, **kw),
            daemon=True,
        )
        p.start()
        processes.append(p)
    return processes


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, action="append")
    parser.add_argument("--ref", required=True)
    parser.add_argument("--port", type=int, default=DFLT_PORT)
    parser.add_argument("--metric", default="llh")
    parser.add_argument("--num", type=int, default=1)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipelines (default: cuda)",
    )
    args = parser.parse_args(argv)
    if args.num == 1:
        serve(args.config, args.ref, port=args.port, metric=args.metric,
              device=args.device)
    else:
        procs = fork_servers(
            args.config, args.ref, port=args.port, num=args.num,
            metric=args.metric, device=args.device,
        )
        for p in procs:
            p.join()


if __name__ == "__main__":
    main()
