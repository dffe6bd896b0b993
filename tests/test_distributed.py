"""Multi-host execution tests: REAL OS processes under jax.distributed.

The reference's parallelism stops at one process of pthreads
(`pathtracer.cpp:243-281`); rrt_tpu's multi-host story (SURVEY §2.5) is one
SPMD program per host federated by `jax.distributed.initialize`. These tests
spawn 2 actual processes with a localhost coordinator on the CPU backend —
gloo stands in for ICI — and assert (a) the cluster federates (4 global
devices from 2×2 local), (b) a lane-sharded forward render over the global
mesh bit-matches the single-device render (checked inside each worker), and
(c) the two processes' shards tile the full frame.

Run serially (two subprocesses already oversubscribe the 2-core host).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
    except (PermissionError, OSError) as e:  # sandboxed environments
        pytest.skip(f"cannot bind localhost sockets here: {e}")
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single_device(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    outs = [tmp_path / f"w{i}.npz" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port), str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    a, b = (np.load(o) for o in outs)
    assert int(a["ndev"]) == 4 and int(a["nproc"]) == 2, dict(a)
    # the two processes' shards tile the frame without overlap
    assert int(a["hi"]) == int(b["lo"])
    full = np.concatenate([a["local"], b["local"]], axis=0)
    assert full.shape[0] == 16 * 16
    assert np.all(np.isfinite(full))
    assert float(np.abs(full).max()) > 0.0
