"""Distributed-BA scaling sweep (BASELINE.md: >=70% scaling efficiency at
N >= 2).

Runs the observation-sharded global-BA step (parallel/dist_ba.py) at mesh
sizes {1,2,4,8} in both strong-scaling (fixed total observations) and
weak-scaling (observations per device fixed) variants, and writes
runs/scaling.json (git-ignored) unless --out says otherwise.

CAVEAT recorded in the output: the sweep runs on a virtual CPU device mesh
(xla_force_host_platform_device_count) whose "devices" share the host's
physical cores, so wall-clock efficiency beyond the core count measures
oversubscription, not the sharded program. With the landmark-block sharding
the per-iteration collective volume is a psum of [P,6,6]x2+[P,6] + cg_iters
x [P,6] (~12 KB at P=64), independent of O and L, so on a real interconnect
the per-observation/per-landmark compute fraction bounds the achievable
efficiency.

Usage: python tools/scaling_bench.py [--out runs/scaling.json]
"""
import argparse
import json
import os
import sys
import time

# force the virtual CPU mesh: the sweep needs 8 devices on any host
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def make_problem(P, L, O, seed=0):
    rng = np.random.default_rng(seed)
    intr = (400.0, 400.0, 320.0, 240.0)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 9, L)], 1).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    kf_t = np.zeros((P, 3), np.float32)
    kf_t[:, 0] = 0.1 * np.arange(P)
    obs_p = rng.integers(0, P, O).astype(np.int32)
    obs_l = rng.integers(0, L, O).astype(np.int32)
    Xc = X[obs_l] + kf_t[obs_p]
    uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                   intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    free = np.array([False] + [True] * (P - 1))
    # perturb initial state so the solve does real work
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    return (kf_R, kf_t, free, X0, np.ones(L, bool),
            obs_p, obs_l, uv, np.ones(O, np.float32), intr)


def time_ba(mesh, prob, P, L, iters=10, reps=5, cg_iters=48):
    from ygz_tpu.parallel.dist_ba import (make_distributed_ba,
                                          partition_obs_by_landmark)

    n_dev = mesh.devices.size
    (kf_R, kf_t, free, X0, ptv, obs_p, obs_l, obs_uv, obs_w, intr) = prob
    op, ol, ouv, our, ow, _ = partition_obs_by_landmark(
        obs_p, obs_l, obs_uv, obs_w, L, n_dev)
    ba = make_distributed_ba(mesh, n_poses=P, n_points=L, iters=iters,
                             cg_iters=cg_iters)
    args = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in (kf_R, kf_t, free, X0, ptv, op, ol, ouv, our, ow,
                           intr, np.float32(0.0)))
    res = ba(*args)
    jax.block_until_ready(res)  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        res = ba(*args)
    jax.block_until_ready(res)
    return (time.perf_counter() - t0) / reps, float(res.total_chi2)


def time_psum_loop(mesh, P, n_psums, reps=20):
    """Collective-only yardstick: the solve's per-GN-iteration psum
    pattern ([P,6] x n_psums) in isolation — what the communication phase
    costs on this mesh with zero local work."""
    from jax.sharding import PartitionSpec as PS
    from jax import shard_map

    axis = "obs"

    def loop(x):
        def body(_, v):
            return jax.lax.psum(v, axis) * (1.0 / mesh.devices.size)
        return jax.lax.fori_loop(0, n_psums, body, x)

    fn = jax.jit(shard_map(loop, mesh=mesh, in_specs=PS(),
                           out_specs=PS(), check_vma=False))
    x = jnp.ones((P, 6))
    jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / reps


def phase_breakdown(mesh, prob, P, L, reps=5):
    """Split one 10-iteration solve into: normal-equation phase (residuals,
    Jacobians, U/V/D blocks, back-substitution; cg_iters=0) vs the PCG
    phase (the remainder), plus the isolated psum cost — the quantified
    answer to WHERE the scaling loss lives (VERDICT r5 #4)."""
    t_full, _ = time_ba(mesh, prob, P, L, iters=10, reps=reps, cg_iters=48)
    t_ne, _ = time_ba(mesh, prob, P, L, iters=10, reps=reps, cg_iters=0)
    # per solve: 10 GN iters x (48 CG psums + 3 block psums) + phase chi2
    t_psum = time_psum_loop(mesh, P, n_psums=10 * 51)
    return {"full_ms": round(t_full * 1e3, 2),
            "normal_eq_ms": round(t_ne * 1e3, 2),
            "cg_ms": round((t_full - t_ne) * 1e3, 2),
            "psum_only_ms": round(t_psum * 1e3, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                  "scaling.json"))
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--obs", type=int, default=65536)
    args = ap.parse_args()

    devs = jax.devices()
    P, L, O = args.poses, args.points, args.obs
    sizes = [n for n in (1, 2, 4, 8) if n <= len(devs)]

    strong, weak, phases = {}, {}, {}
    for n in sizes:
        mesh = Mesh(np.array(devs[:n]), ("obs",))
        prob = make_problem(P, L, O)
        t, chi = time_ba(mesh, prob, P, L)
        strong[n] = t
        print(f"strong n={n}: {t * 1e3:.1f} ms/solve chi2={chi:.1f}",
              flush=True)
        phases[n] = phase_breakdown(mesh, prob, P, L)
        print(f"phases n={n}: {phases[n]}", flush=True)
        prob_w = make_problem(P, L, O * n // max(sizes))
        t, chi = time_ba(mesh, prob_w, P, L)
        weak[n] = t
        print(f"weak   n={n}: {t * 1e3:.1f} ms/solve (O={O * n // max(sizes)})",
              flush=True)

    out = {
        "problem": {"poses": P, "points": L, "observations": O,
                    "iters_per_solve": 10},
        "platform": str(devs[0].platform),
        "n_physical_devices_note": (
            f"virtual CPU mesh over {os.cpu_count()} physical host cores. "
            "Wall-clock efficiency beyond the physical core count measures "
            "oversubscription, not the sharded program; per-iteration "
            "collective volume is ~0.7 MB at P=64, independent of O and L"),
        "strong_ms_per_solve": {str(n): round(strong[n] * 1e3, 2)
                                for n in sizes},
        "weak_ms_per_solve": {str(n): round(weak[n] * 1e3, 2) for n in sizes},
        "strong_efficiency": {str(n): round(strong[1] / (n * strong[n]), 3)
                              for n in sizes},
        "weak_efficiency": {str(n): round(weak[1] / weak[n], 3)
                            for n in sizes},
        # per-phase split of one solve (VERDICT r5 #4): normal-equation
        # phase (sharded per-observation compute) vs PCG phase (dominated
        # by replicated [P,6] vector work + psums) vs the isolated psum
        # loop — whichever phase stops shrinking with n carries the loss
        "phase_breakdown_ms": {str(n): phases[n] for n in sizes},
        "target": ">=0.70 at N>=2 (BASELINE.md)",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
