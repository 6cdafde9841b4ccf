"""Multi-process distributed-BA worker (one real process per 'host').

Driven by tests/test_multihost.py: N copies of this script start, each
initializes jax's multi-process runtime over a localhost coordinator
(parallel/multihost.py `init_distributed`), contributes its own CPU
devices, and runs the landmark-block-sharded BA (parallel/dist_ba.py)
over the GLOBAL mesh — the same program a real multi-host GPU job
compiles, with the psum collectives crossing the process boundary (the
cross-host analog). Process 0 prints the result for the test to compare against
a single-process solve.

Usage: python tools/multihost_worker.py <coordinator> <num_procs> <pid>
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# each process contributes 2 CPU devices -> global mesh of 2*num_procs
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402

# the env var alone does not displace an installed accelerator plugin —
# pin the platform explicitly too
jax.config.update("jax_platforms", "cpu")


def build_problem(seed=0, P=4, L=64, O=1024, intr=(400.0, 400.0, 320.0,
                                                   240.0)):
    """Deterministic BA problem — identical in every process."""
    import jax.numpy as jnp
    from ygz_tpu.geometry import lie

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    poses = []
    for p in range(P):
        w = rng.standard_normal(3).astype(np.float32) * 0.02
        t = np.array([0.3 * p, 0.0, 0.0], np.float32)
        poses.append((np.asarray(lie.so3_exp(jnp.asarray(w))), t))
    obs_p, obs_l, obs_uv = [], [], []
    for p, (R, t) in enumerate(poses):
        Xc = X @ R.T + t
        uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                       intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
        uv += rng.standard_normal(uv.shape).astype(np.float32) * 0.2
        inb = ((uv > 10).all(1) & (uv < [630, 470]).all(1))
        for li in np.nonzero(inb)[0]:
            obs_p.append(p)
            obs_l.append(li)
            obs_uv.append(uv[li])
    n = len(obs_p)
    pad = O - n
    obs_p = np.array(obs_p + [0] * pad, np.int32)
    obs_l = np.array(obs_l + [0] * pad, np.int32)
    obs_uv = np.concatenate([np.asarray(obs_uv, np.float32),
                             np.zeros((pad, 2), np.float32)])
    obs_w = np.array([1.0] * n + [0.0] * pad, np.float32)
    X0 = X + rng.standard_normal(X.shape).astype(np.float32) * 0.05
    kf_R = np.stack([R for (R, t) in poses])
    kf_t = np.stack([t + rng.standard_normal(3).astype(np.float32) * 0.02
                     for (R, t) in poses])
    free = np.array([False, False] + [True] * (P - 2))
    return kf_R, kf_t, free, X0, obs_p, obs_l, obs_uv, obs_w, intr


def main():
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from ygz_tpu.parallel.multihost import init_distributed, global_ba_mesh
    init_distributed(coordinator_address=coord, num_processes=n_proc,
                     process_id=pid)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from ygz_tpu.parallel.dist_ba import (make_distributed_ba,
                                          partition_obs_by_landmark)

    assert len(jax.devices()) == 2 * n_proc, jax.devices()
    mesh = global_ba_mesh()
    n_dev = mesh.devices.size

    P, L = 4, 64
    (kf_R, kf_t, free, X0, obs_p, obs_l, obs_uv, obs_w,
     intr) = build_problem(P=P, L=L)
    op, ol, ouv, our, ow, _ = partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, n_dev)

    def gput(a, spec):
        """Host numpy -> GLOBAL jax.Array over the multi-process mesh."""
        a = np.asarray(a)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            a.shape, sh, lambda idx: a[idx])

    axis = PS("obs")
    rep = PS()
    args = (gput(kf_R, rep), gput(kf_t, rep), gput(free, rep),
            gput(X0, axis), gput(np.ones(L, bool), axis),
            gput(op, axis), gput(ol, axis), gput(ouv, axis),
            gput(our, axis), gput(ow, axis), intr, np.float32(0.0))
    ba = make_distributed_ba(mesh, n_poses=P, n_points=L, iters=12)
    res = ba(*args)
    jax.block_until_ready(res)
    # kf_t / total_chi2 are REPLICATED over the global mesh: every device
    # (so every process) holds the full value — read the local copy
    kf_t_out = np.asarray(res.kf_t.addressable_data(0))
    chi2 = float(np.asarray(res.total_chi2.addressable_data(0)))
    if pid == 0:
        print("RESULT", chi2,
              " ".join(f"{v:.6f}" for v in kf_t_out.ravel()), flush=True)


if __name__ == "__main__":
    main()
