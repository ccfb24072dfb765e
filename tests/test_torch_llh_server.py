"""
The port's llh server and client (``pisa_tpu_torch/utils/llh_server.py``,
``llh_client.py``) against the JAX package's, in fp64 on the CPU
(conftest), on ``settings/pipeline/toy_generalized_llh.cfg`` as
tests/test_llh_server.py runs it: ``serve`` in a thread on a free port
(never the JAX test's fixed 19472), and at two points the served llh
equals the port's in-process objective to 1e-12 relative (the same
arithmetic, one route) and the JAX package's in-process
``-value_only(x)`` to 1e-9 (another package, another summation order).

Also: a two-pipeline config takes the eager route, a compile that fails
raises (no fallback), ``fork_servers`` spawns its servers, and the wire
format is byte-equal to the JAX module's.
"""

import multiprocessing
import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest

from pisa_tpu.core.map import MapSet as JaxMapSet
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu.utils import llh_server as jax_llh_server
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.utils import llh_server
from pisa_tpu_torch.utils.llh_client import Client, get_llh

CFG = "settings/pipeline/toy_generalized_llh.cfg"
PORT_RTOL = 1e-12
JAX_RTOL = 1e-9


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def connect(port, timeout=60.0):
    """A client of the server on `port`, once it listens."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return Client(("localhost", port))
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's template at nominal as the reference, written to JSON; a
    server over it in a thread; the two points and the port's objective."""
    p = Pipeline(CFG, device="cpu")
    ct = p.compile()
    ref = ct.get_outputs()
    ref_path = str(tmp_path_factory.mktemp("llh") / "ref.json")
    ref.to_json(ref_path)
    port = free_port()
    threading.Thread(
        target=llh_server.serve,
        kwargs=dict(config=CFG, ref=ref_path, port=port, metric="llh",
                    device="cpu"),
        daemon=True,
    ).start()
    value_only, _ = ct.build_objective(ref, "llh")
    v0 = ct.current_rescaled_values()
    points = (v0, np.clip(v0 + 0.1, 0.05, 0.95))
    return port, ref_path, points, value_only


def test_served_llh_matches_both_packages(served):
    port, ref_path, points, value_only = served
    jax_ct = JaxPipeline(CFG).compile()
    jax_value_only, _ = jax_ct.build_objective(
        JaxMapSet.from_json(ref_path), "llh")
    with connect(port) as client:
        for v in points:
            got = client.get_llh(v)
            assert isinstance(got, float)
            want = -float(value_only(np.asarray(v)))
            assert got == pytest.approx(want, rel=PORT_RTOL, abs=0)
            jax_want = -float(jax_value_only(np.asarray(v)))
            assert got == pytest.approx(jax_want, rel=JAX_RTOL, abs=0)
    # the round-robin pool of the emcee log-prob function
    v = points[1]
    assert get_llh(v, [f"localhost:{port}"]) == pytest.approx(
        -float(value_only(np.asarray(v))), rel=PORT_RTOL, abs=0)


def test_two_pipelines_take_the_eager_route(served, monkeypatch):
    """With two pipelines the served value is the eager DistributionMaker's
    summed template's metric (JAX's sign: the llh as it is maximized); no
    template is compiled."""
    _, _, points, _ = served
    dm = DistributionMaker([CFG, CFG], device="cpu")
    ref = dm.get_outputs(return_sum=True)

    def no_compile(self, *args, **kwargs):
        raise AssertionError("the eager route compiled a template")

    monkeypatch.setattr(Pipeline, "compile", no_compile)
    llh = llh_server.llh_function(dm, ref, "llh")
    for v in points:
        got = llh(v)
        dm._set_rescaled_free_params(np.asarray(v))
        want = float(ref.metric_total(dm.get_outputs(return_sum=True), "llh"))
        assert got == pytest.approx(want, rel=PORT_RTOL, abs=0)
    chi2 = llh_server.llh_function(dm, ref, "chi2")
    assert chi2(points[1]) < 0  # a chi2 served with the minimized sign


def test_failed_compile_raises(monkeypatch):
    """One pipeline goes to its compiled objective; a compile that fails
    raises instead of falling back to the eager route."""
    dm = DistributionMaker([CFG], device="cpu")
    ref = dm.get_outputs(return_sum=True)

    def broken(self, *args, **kwargs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(Pipeline, "compile", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        llh_server.llh_function(dm, ref, "llh")


def test_fork_servers_spawns(served):
    """fork_servers starts spawned processes (a forked child could not use
    CUDA once its parent had), whose arguments pickle, and each serves."""
    _, ref_path, points, value_only = served
    port = free_port()
    procs = llh_server.fork_servers(CFG, ref_path, port=port, num=1,
                                    metric="llh", device="cpu")
    try:
        assert [type(p) for p in procs] == [
            multiprocessing.get_context("spawn").Process]
        with connect(port, timeout=120.0) as client:
            got = client.get_llh(points[1])
        assert got == pytest.approx(-float(value_only(points[1])),
                                    rel=PORT_RTOL, abs=0)
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=30)
    assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("obj", [[0.25, 0.5, 0.75], -1234.5678, {"x": (1,)}])
def test_wire_format_is_jax_bytes(obj):
    """send_obj writes what the JAX module writes (a 4-byte big-endian
    length, then the pickle), and receive_obj reads it back, also when it
    arrives a byte at a time."""
    frames = []
    for module in (llh_server, jax_llh_server):
        a, b = socket.socketpair()
        with a, b:
            module.send_obj(obj, a)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while chunk := b.recv(65536):
                data += chunk
        frames.append(data)
    assert frames[0] == frames[1]
    payload = pickle.dumps(obj)
    assert frames[0] == struct.pack("!i", len(payload)) + payload

    a, b = socket.socketpair()
    with a, b:
        def trickle():
            for i in range(len(frames[0])):
                a.sendall(frames[0][i:i + 1])

        t = threading.Thread(target=trickle)
        t.start()
        assert llh_server.receive_obj(b) == obj
        t.join(timeout=10)
        a.close()
        with pytest.raises(llh_server.ConnectionClosed):
            llh_server.receive_obj(b)
