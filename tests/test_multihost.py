"""Multi-process distributed BA: two REAL processes (the boundary a
multi-host job crosses over the network) solve the sharded problem via
parallel/multihost.py + parallel/dist_ba.py and must match a
single-process virtual-mesh solve (SURVEY.md §4 item d; VERDICT r3: the
multihost bootstrap must be driven by an actual multi-process mesh)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tools", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_dist_ba_matches_single_process():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    n_proc = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)        # worker sets its own device count
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(n_proc), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(n_proc)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{err[-2000:]}"
    result_lines = [ln for rc, out, err in outs
                    for ln in out.splitlines() if ln.startswith("RESULT")]
    assert len(result_lines) == 1, outs
    parts = result_lines[0].split()
    chi2_mp = float(parts[1])
    kf_t_mp = np.array([float(v) for v in parts[2:]]).reshape(-1, 3)

    # single-process reference on a 4-device virtual mesh (same problem)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from multihost_worker import build_problem
    from ygz_tpu.parallel.dist_ba import (make_distributed_ba,
                                          partition_obs_by_landmark)
    P, L = 4, 64
    (kf_R, kf_t, free, X0, obs_p, obs_l, obs_uv, obs_w,
     intr) = build_problem(P=P, L=L)
    n_dev = 4
    assert len(jax.devices()) >= n_dev
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("obs",))
    op, ol, ouv, our, ow, _ = partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, n_dev)
    ba = make_distributed_ba(mesh, n_poses=P, n_points=L, iters=12)
    res = ba(jnp.asarray(kf_R), jnp.asarray(kf_t), jnp.asarray(free),
             jnp.asarray(X0), jnp.ones(L, bool),
             jnp.asarray(op), jnp.asarray(ol), jnp.asarray(ouv),
             jnp.asarray(our), jnp.asarray(ow), intr, np.float32(0.0))
    kf_t_sp = np.asarray(res.kf_t)
    chi2_sp = float(res.total_chi2)

    np.testing.assert_allclose(kf_t_mp, kf_t_sp, atol=1e-4)
    assert abs(chi2_mp - chi2_sp) < 0.01 * max(chi2_sp, 1.0), \
        (chi2_mp, chi2_sp)
