"""
llh client: query :mod:`pisa_tpu_torch.utils.llh_server` servers
(counterpart of ``pisa_tpu/utils/llh_client.py``; cf. reference
``pisa/utils/llh_client.py``): a round-robin client pool with an
emcee-compatible ``get_llh`` and ``setup_sampler``.
"""

from __future__ import annotations

import socket
from itertools import cycle

from pisa_tpu_torch.utils.llh_server import receive_obj, send_obj

__all__ = ["Client", "get_llh", "setup_sampler"]


class Client:
    """One TCP connection to an llh server."""

    def __init__(self, server_address):
        if isinstance(server_address, str):
            host, _, port = server_address.partition(":")
            server_address = (host, int(port))
        self.server_address = tuple(server_address)
        self.sock = None
        self.connect()

    def connect(self):
        self.sock = socket.create_connection(self.server_address)

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def get_llh(self, x):
        """llh at rescaled free-param vector `x`."""
        send_obj(list(map(float, x)), self.sock)
        return receive_obj(self.sock)


_POOLS = {}


def get_llh(x, server_infos):
    """Round-robin llh evaluation over several servers (emcee-compatible
    log-prob function when bound via functools.partial)."""
    key = tuple(map(tuple, server_infos)) if not isinstance(
        server_infos, str
    ) else server_infos
    if key not in _POOLS:
        infos = (
            [server_infos] if isinstance(server_infos, str) else server_infos
        )
        _POOLS[key] = cycle([Client(info) for info in infos])
    client = next(_POOLS[key])
    return client.get_llh(x)


def setup_sampler(nwalkers, ndim, host_port_num, **kwargs):
    """emcee EnsembleSampler over the server pool (requires emcee; prefer
    :func:`pisa_tpu_torch.analysis.bayesian.mcmc_sampling`, which runs
    the walkers as lanes on the device)."""
    import emcee
    from functools import partial

    log_prob = partial(get_llh, server_infos=host_port_num)
    return emcee.EnsembleSampler(nwalkers, ndim, log_prob, **kwargs)
