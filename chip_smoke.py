"""Smoke check of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py           # phases A-C on one GPU
    python chip_smoke.py --four    # distributed global BA on a 4-GPU mesh

Runs in one process and needs a GPU: with no GPU (for example under
JAX_PLATFORMS=cpu) it exits non-zero at the device check and prints no
result. Numerics are float32 everywhere: the package sets
`jax_default_matmul_precision="float32"`, so no matmul runs in TF32.

Phase A  `frame_step_batch` (the fused per-frame tracking program) at the
         benchmark's shapes, on the GPU and on the host CPU with the same
         inputs; poses, tracked-point uv and per-point ok masks compared.
Phase B  `fast_score_map` at 752x480 and `hamming_matrix` at 1024x1024
         against plain numpy references (exactly equal), plus the card time
         of `fast_score_map`.
Phase C  the whole monocular system through `System.track_monocular_batch`
         on the benchmark's EuRoC-cadence sequence; frames OK and 7-DoF ATE
         against the rendered ground truth are gated.

The figures printed are smoke figures, not a benchmark (`bench.py` is the
benchmark). Any failed phase raises, so the exit code is non-zero; the last
line of standard output is the JSON result only when every phase passed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

# Phase A tolerances (GPU against the host CPU, same inputs, float32, no
# TF32). XLA orders reductions differently on the two backends, so the GN
# solves differ in the last bits, and a point near a threshold (inlier
# test, KLT convergence) may flip.
# - poses: 1e-3 rad and scene units, a third of the fixture's own error
#   against the truth (up to 3.4e-3 over 32 frames on XLA:CPU);
# - uv: median under 0.02 px, below the KLT's 0.03 px convergence step, so
#   both backends stop on the same iterate;
# - ok masks: 98% agreement leaves room for the few threshold flips.
POSE_TOL = 1e-3
UV_TOL_PX = 0.02
OK_AGREE = 0.98

# Phase C gates. CPU_ATE is this script's Phase C run on the host CPU
# (XLA:CPU, 2026-10-16); the GPU run may be at most twice as far off.
FRAMES_OK_MIN = 0.95
CPU_ATE = 0.0155
ATE_FLOOR = 0.05

# --four tolerances, after a 7-DoF alignment (see `phase_four`): rad and
# scene units. The solve's own error against the truth is ~0.09 (XLA:CPU,
# 4 virtual devices); there the mesh agreed with the same solver on one
# device to 1.2e-3 and with the dense solver to 0.012, chi2 to 1e-5.
FOUR_SAME_TOL = 5e-3
FOUR_DENSE_TOL = 3e-2
FOUR_CHI2_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ devices
def require_gpu(devices):
    """Refuse anything but a GPU: there is no CPU fallback."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {kind}")


def result_line(devices) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


@contextlib.contextmanager
def _no_persistent_cache():
    """Run the CPU reference without the persistent compilation cache (read
    or write): XLA:CPU executables reloaded from it compute different
    numerics (see ygz_tpu.utils.compile_cache), and JAX_COMPILATION_CACHE_DIR
    turns the cache on for every backend of the process."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    old = jax.config.jax_enable_compilation_cache
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", old)
        cc.reset_cache()


# ------------------------------------------------------------------ phase A
def scene_fixture(batch=32, cap=512):
    """Inputs of one `frame_step_batch` call on the benchmark's sequence, as
    numpy: frames 1..batch of the rendered 752x480 sequence, tracked from
    frame 0's true pose with a cache of up to `cap` points (one per grid
    cell, at its largest image gradient), world positions from the exact
    surface depth and 20x20 reference patches from frame 0.

    A well-posed tracking problem, unlike bench.py's random-noise pipeline
    fixture: on noise a 1e-7 relative change of the inputs already moves
    poses by 0.45 scene units (XLA:CPU), so a backend comparison there
    measures the chaos, not the backend."""
    import jax
    import jax.numpy as jnp
    import bench
    from ygz_tpu.frontend.direct_tracker import capture_ref_patches
    from ygz_tpu.frontend.framestep import (build_pyramid_stacked,
                                            make_carry, pack_cache_np)

    W, H, F = bench.W, bench.H, bench.F
    scene = bench.make_scene()
    frames = bench.render_sequence(batch + 1, scene)
    gy, gx = np.gradient(frames[0].astype(np.float32))
    grad = np.hypot(gx, gy)
    cols = int(np.sqrt(2 * cap))
    rows = cap // cols
    xe = np.linspace(24, W - 24, cols + 1).astype(int)
    ye = np.linspace(24, H - 24, rows + 1).astype(int)
    uv = np.zeros((cap, 2), np.float32)
    for r in range(rows):
        for c in range(cols):
            cell = grad[ye[r]: ye[r + 1], xe[c]: xe[c + 1]]
            y, x = np.unravel_index(np.argmax(cell), cell.shape)
            uv[r * cols + c] = (xe[c] + x, ye[r] + y)
    valid = np.arange(cap) < rows * cols
    R0, t0 = bench.euroc_pose(0)
    d_cam = np.stack([(uv[:, 0] - scene.cx) / F, (uv[:, 1] - scene.cy) / F,
                      np.ones(cap, np.float32)], 1)
    o_w = -R0.T @ t0
    d_w = d_cam @ R0
    X = (o_w + scene._intersect(o_w, d_w)[:, None] * d_w).astype(np.float32)
    level = np.zeros(cap, np.int32)
    pyr0 = build_pyramid_stacked(jnp.asarray(frames[0]), None, 4, 2.0)
    patch = np.asarray(capture_ref_patches(pyr0, jnp.asarray(uv),
                                           jnp.asarray(level)))
    cache = pack_cache_np(X, valid, patch, uv, level,
                          np.tile(R0, (cap, 1, 1)), np.tile(t0, (cap, 1)))
    carry = make_carry(pyr0, R0, t0, uv, X @ R0.T + t0, valid)
    intr = (F, F, W / 2.0 - 0.5, H / 2.0 - 0.5)
    return frames[1:], jax.tree.map(np.asarray, carry), cache, intr


def run_frame_step(device, fixture):
    """`frame_step_batch` over `fixture` (see scene_fixture) on `device`.
    Returns the packed per-frame outputs [B, N_SCALARS+5*cap] as numpy."""
    import jax
    from ygz_tpu.frontend.framestep import frame_step_batch

    imgs, carry, cache = jax.device_put(fixture[:3], device)
    _, outs, _ = frame_step_batch(imgs, carry, cache, None, fixture[3])
    return np.asarray(outs)


def rot_angle(Ra, Rb):
    """Angle (rad) of Ra^T Rb, from its skew part: well conditioned for the
    small angles compared here, unlike arccos of the trace."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(np.linalg.norm(s) / 2, (np.trace(M) - 1) / 2))


def compare_frame_steps(ref, got, cap):
    """Compare two packed `frame_step_batch` outputs frame by frame.
    Returns (metrics, failures); failures is empty when within tolerance."""
    from ygz_tpu.frontend.framestep import unpack_out

    rot, trans, uv_diff, agree = [], [], [], []
    for a, b in zip(ref, got):
        fa, fb = unpack_out(a, cap), unpack_out(b, cap)
        rot.append(rot_angle(fa.R, fb.R))
        trans.append(float(np.linalg.norm(fa.t - fb.t)))
        both = fa.tracked & fb.tracked
        uv_diff.append(np.abs(fa.uv[both] - fb.uv[both]).ravel())
        agree.append(fa.tracked == fb.tracked)
    uv_diff = np.concatenate(uv_diff)
    m = {"max_rot_rad": max(rot), "max_trans": max(trans),
         "uv_median_px": float(np.median(uv_diff)) if uv_diff.size else 0.0,
         "n_tracked_pairs": int(uv_diff.size // 2),
         "ok_agree": float(np.mean(np.concatenate(agree)))}
    failures = []
    if not m["max_rot_rad"] <= POSE_TOL:
        failures.append(f"rotation differs by {m['max_rot_rad']:.3g} rad")
    if not m["max_trans"] <= POSE_TOL:
        failures.append(f"translation differs by {m['max_trans']:.3g}")
    if not m["uv_median_px"] <= UV_TOL_PX:
        failures.append(f"median uv differs by {m['uv_median_px']:.3g} px")
    if not m["ok_agree"] >= OK_AGREE:
        failures.append(f"ok masks agree on {m['ok_agree']:.4f} only")
    return m, failures


def phase_a(gpu, cpu, batch=32, cap=512):
    import jax

    t0 = time.perf_counter()
    with _no_persistent_cache(), jax.default_device(cpu):
        fixture = scene_fixture(batch, cap)
        ref = run_frame_step(cpu, fixture)
    got = run_frame_step(gpu, fixture)
    m, failures = compare_frame_steps(ref, got, cap)
    log(f"phase A: frame_step_batch B={batch} 752x480 cap={cap} "
        f"GPU vs CPU: max rot {m['max_rot_rad']:.3g} rad, max trans "
        f"{m['max_trans']:.3g}, median uv {m['uv_median_px']:.3g} px over "
        f"{m['n_tracked_pairs']} points, ok agree {m['ok_agree']:.4f} "
        f"({time.perf_counter() - t0:.1f}s)")
    if failures:
        raise AssertionError("phase A: " + "; ".join(failures))


# ------------------------------------------------------------------ phase B
def _device_ms(fn, *args, reps=50):
    """Median wall time of fn(*args) to completion, in ms (after a warm
    call that compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_b(gpu):
    import jax
    from ygz_tpu.ops.fast import fast_score_map, fast_score_map_ref
    from ygz_tpu.ops.matching import hamming_matrix, hamming_matrix_ref

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (480, 752)).astype(np.float32)
    img_dev = jax.device_put(img, gpu)
    for th in (20.0, 7.0):
        got = np.asarray(fast_score_map(img_dev, th))
        ref = fast_score_map_ref(img, th)
        n_bad = int((got != ref).sum())
        log(f"phase B: fast_score_map 752x480 th={th:g}: "
            f"{int((ref > 0).sum())} corners, {n_bad} pixels differ")
        if n_bad:
            raise AssertionError(f"phase B: fast_score_map th={th} differs "
                                 f"at {n_bad} pixels")
    fast_ms = _device_ms(lambda x: fast_score_map(x, 20.0), img_dev)
    log(f"phase B: fast_score_map 752x480 card time {fast_ms:.4f} ms "
        "(median of 50, smoke figure)")

    b1 = rng.integers(0, 2, (1024, 256)).astype(np.uint8)
    b2 = rng.integers(0, 2, (1024, 256)).astype(np.uint8)
    got = np.asarray(jax.jit(hamming_matrix)(jax.device_put(b1, gpu),
                                             jax.device_put(b2, gpu)))
    ref = hamming_matrix_ref(b1, b2)
    n_bad = int((got != ref).sum())
    log(f"phase B: hamming_matrix 1024x1024: {n_bad} entries differ")
    if n_bad:
        raise AssertionError(f"phase B: hamming_matrix differs at {n_bad} "
                             "entries")


# ------------------------------------------------------------------ phase C
def phase_c():
    """The monocular system end to end on JAX's default device. Returns
    (frames_ok, n_timed, ate)."""
    import jax
    import bench
    from ygz_tpu.eval.ate import ate_rmse
    from ygz_tpu.frontend.tracker import TrackerConfig
    from ygz_tpu.geometry import camera as cam_mod
    from ygz_tpu.system import System, Sensor
    from ygz_tpu.warmup import warmup_tracking

    warm = bench.WARM_FRAMES
    B, W, H, F = bench.BATCH, bench.W, bench.H, bench.F
    t0 = time.perf_counter()
    frames = bench.render_sequence()
    ts = [i * 0.05 for i in range(len(frames))]
    log(f"phase C: rendered {len(frames)} frames {W}x{H} "
        f"({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    cam = cam_mod.Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)
    warmup_tracking(cam, TrackerConfig(async_mapping=False, track_batch=B),
                    n_frames=max(6, B) + 2 * B)
    sys_ = System(cam, Sensor.MONOCULAR,
                  config=TrackerConfig(async_mapping=True, track_batch=B))
    for i in range(0, warm, B):
        j = min(i + B, warm)
        sys_.track_monocular_batch(list(frames[i: j]), ts[i: j])
    sys_.tracker.warm_failure_paths()
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    i = warm
    while i < len(frames):
        r = sys_.track_monocular_batch(list(frames[i: i + 3 * B]),
                                       ts[i: i + 3 * B])
        i += len(r)
    sys_.shutdown()
    loop_s = time.perf_counter() - t0

    est, gt = [], []
    timed = sys_.trajectory[warm:]
    for k, rec in enumerate(timed):
        if rec.state != "OK":
            continue
        R, t = sys_.tracker.recovered_pose(rec)
        est.append(-np.asarray(R).T @ np.asarray(t))
        Rg, tg = bench.euroc_pose(warm + k)
        gt.append(-Rg.T @ tg)
    n_ok = len(est)
    ate = ate_rmse(np.asarray(est), np.asarray(gt), with_scale=True)[0] \
        if n_ok >= 3 else float("inf")
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    lost = [k for k, rec in enumerate(timed) if rec.state != "OK"]
    for line in (f"frames OK {n_ok}/{len(timed)} (not OK: {lost})",
                 f"ATE {ate:.5f} (7-DoF Horn, recovered poses)",
                 f"keyframes {sys_.tracker.stats()['n_kf']}",
                 f"compile + warm-up {setup_s:.1f} s",
                 f"timed loop {len(timed) / loop_s:.2f} FPS",
                 f"peak_bytes_in_use "
                 f"{stats.get('peak_bytes_in_use', 'n/a')}"):
        log(f"phase C (smoke figure, not a benchmark): {line}")
    return n_ok, len(timed), ate


def check_phase_c(n_ok, n_timed, ate):
    bound = max(2.0 * CPU_ATE, ATE_FLOOR)
    if n_ok < FRAMES_OK_MIN * n_timed:
        raise AssertionError(f"phase C: only {n_ok}/{n_timed} frames OK")
    if not ate <= bound:
        raise AssertionError(f"phase C: ATE {ate:.5f} above {bound:.5f}")
    log(f"phase C: passed (frames OK >= {FRAMES_OK_MIN:.0%}, "
        f"ATE <= {bound:.5f})")


# ------------------------------------------------------------------ --four
def build_ba_map(n_kf=64, n_pt=8192, obs_per_pt=4, seed=0):
    """A map at the global-BA bucket the mapper really uses (64 keyframes,
    8192 points, 32768 observations): keyframes at every 4th frame of the
    benchmark's trajectory, each point seen by 4 of the 8 keyframes nearest
    to it, 0.5 px pixel noise, keyframes 1.. and all points perturbed from
    the truth. Returns (map, camera, true rotations, true translations,
    true points)."""
    from ygz_tpu.backend.mapstate import SlamMap
    from ygz_tpu.geometry import camera as cam_mod

    import bench

    rng = np.random.default_rng(seed)
    W, H, F = bench.W, bench.H, bench.F
    cam = cam_mod.Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)
    poses = [bench.euroc_pose(4 * k) for k in range(n_kf)]
    Rs = np.stack([R for R, _ in poses])
    ts = np.stack([t for _, t in poses])
    cs = -np.einsum("kji,kj->ki", Rs, ts)
    X = np.stack([rng.uniform(cs[0, 0] - 0.5, cs[-1, 0] + 0.5, n_pt),
                  rng.uniform(-2, 2, n_pt),
                  rng.uniform(4, 9, n_pt)], 1).astype(np.float32)
    near = np.argsort(np.abs(X[:, :1] - cs[None, :, 0]), axis=1)[:, :8]
    who = np.stack([rng.choice(near[p], obs_per_pt, replace=False)
                    for p in range(n_pt)])
    smap = SlamMap(max_kf=n_kf, max_pt=n_pt, max_feat=2048)
    ids = smap.alloc_points(n_pt)
    smap.pt_xyz[ids] = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    smap.pt_valid[ids] = True
    for k in range(n_kf):
        pts = np.nonzero((who == k).any(1))[0]
        assert len(pts) <= smap.max_feat, len(pts)
        Xc = X[pts] @ Rs[k].T + ts[k]
        uv = np.stack([F * Xc[:, 0] / Xc[:, 2] + cam.cx,
                       F * Xc[:, 1] / Xc[:, 2] + cam.cy], 1)
        uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
        m = len(pts)
        feats = {"uv": uv, "level": np.zeros(m, np.int32),
                 "angle": np.zeros(m, np.float32),
                 "desc": np.zeros((m, 256), np.uint8),
                 "valid": np.ones(m, bool)}
        dR = bench.so3_np(rng.normal(0, 0.005, 3).astype(np.float32))
        dt = rng.normal(0, 0.02, 3).astype(np.float32)
        R0, t0 = (Rs[k], ts[k]) if k == 0 else (dR @ Rs[k], ts[k] + dt)
        smap.add_keyframe(R0, t0, feats)
        smap.bind(k, np.arange(m), ids[pts])
    return smap, cam, Rs, ts, X


def map_chi2(smap, cam):
    """Total reprojection chi2 of every observation in the map (float64)."""
    kfs = [k for k in range(smap.n_kf) if smap.kf_valid[k]]
    pts = smap.points_in_kfs(kfs)
    o_kf, o_pt, o_uv, o_lvl, _ = smap.observations(kfs, pts)
    R = smap.kf_R[kfs][o_kf].astype(np.float64)
    t = smap.kf_t[kfs][o_kf].astype(np.float64)
    Xc = np.einsum("nij,nj->ni", R, smap.pt_xyz[pts][o_pt]) + t
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], 1)
    return float((((uv - o_uv) ** 2).sum(1) * 0.25 ** o_lvl).sum())


def align_poses(Ra, ta, Xa, Rb, tb, Xb):
    """Bring solution b (poses, points) into solution a's gauge: the 7-DoF
    similarity that best maps b's camera centres and points onto a's
    (monocular BA fixes one keyframe, so scale stays free and two solvers
    may settle at different scales with the same chi2). Returns (max
    rotation difference rad, max centre difference, scale of b to a)."""
    from ygz_tpu.eval.ate import horn_align

    ca = -np.einsum("kji,kj->ki", Ra, ta)
    cb = -np.einsum("kji,kj->ki", Rb, tb)
    s, R, t = horn_align(np.concatenate([cb, Xb]), np.concatenate([ca, Xa]),
                         with_scale=True)
    cb = s * cb @ R.T + t
    rot = max(rot_angle(Ra[k], Rb[k] @ R.T) for k in range(len(Ra)))
    return rot, float(np.linalg.norm(ca - cb, axis=1).max()), float(s)


def phase_four(devices):
    """`LocalMapper.global_ba` on a 4-device mesh (landmark-block-sharded
    PCG, parallel/dist_ba.py) against the same map solved on one device,
    twice: by the same solver on a 1-device mesh, and by the dense Schur
    solver the mapper uses without a mesh (backend/optim.py). Monocular BA
    fixes one keyframe, so scale and the flat directions of a long strip
    of keyframes are loosely pinned: reduction order alone moves them, and
    PCG with 48 inner iterations stops elsewhere on them than a direct
    solve. So poses are compared after a 7-DoF alignment, within
    FOUR_SAME_TOL of the same solver and FOUR_DENSE_TOL of the dense one,
    and total chi2 within FOUR_CHI2_RTOL of both. Returns the metrics."""
    import copy

    import jax
    from jax.sharding import Mesh
    from ygz_tpu.backend.mapping import LocalMapper

    smap, cam, Rs, ts, X = build_ba_map()
    chi0 = map_chi2(smap, cam)
    L, n = len(X), smap.n_kf
    meshes = {"dense": None, "mesh1": Mesh(np.array(devices[:1]), ("obs",)),
              "mesh4": Mesh(np.array(devices[:4]), ("obs",))}
    maps, secs = {}, {}
    for name, mesh in meshes.items():
        with jax.default_device(devices[0]):
            mapper = LocalMapper(cam, mesh=mesh)
            mapper.global_ba(copy.deepcopy(smap))        # compiles
            m = copy.deepcopy(smap)
            t0 = time.perf_counter()
            mapper.global_ba(m)
            secs[name] = time.perf_counter() - t0
        maps[name] = m

    def pose_diff(a, b):
        return align_poses(a.kf_R[:n], a.kf_t[:n], a.pt_xyz[:L],
                           b.kf_R[:n], b.kf_t[:n], b.pt_xyz[:L])

    chi = {k: map_chi2(m, cam) for k, m in maps.items()}
    res = {"chi2_start": chi0, "chi2": chi, "solve_s": secs,
           "mesh4_vs_mesh1": pose_diff(maps["mesh1"], maps["mesh4"]),
           "mesh4_vs_dense": pose_diff(maps["dense"], maps["mesh4"]),
           "centre_err_vs_truth": {
               k: align_poses(Rs, ts, X, m.kf_R[:n], m.kf_t[:n],
                              m.pt_xyz[:L])[1] for k, m in maps.items()}}
    log("four: global BA 64 KF / 8192 points / 32768 obs on a 4-device "
        "mesh against one device: " + json.dumps(res))
    for other, tol in (("mesh1", FOUR_SAME_TOL), ("dense", FOUR_DENSE_TOL)):
        rot, trans, _ = res["mesh4_vs_" + other]
        if not (rot <= tol and trans <= tol):
            raise AssertionError(f"four: poses differ from {other} by "
                                 f"{rot:.3g} rad, {trans:.3g}")
        if not abs(chi["mesh4"] - chi[other]) <= FOUR_CHI2_RTOL * chi[other]:
            raise AssertionError(f"four: chi2 {chi['mesh4']:.8g} vs {other} "
                                 f"{chi[other]:.8g}")
    if not chi["dense"] < 0.01 * chi0:
        raise AssertionError(f"four: BA did not converge ({chi0} -> "
                             f"{chi['dense']})")
    return res


# ------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the distributed global BA on 4 GPUs, "
                         "compared with the single-device solve")
    args = ap.parse_args(argv)

    # the CPU reference of phase A needs the host backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = jax.devices()
    require_gpu(devices)
    import bench

    log(f"card: {bench.card_info()}")
    log(f"jax {jax.__version__}: {devices[0].device_kind} x{len(devices)}")
    from ygz_tpu.utils.compile_cache import enable

    log(f"compile cache: {enable()}")
    log(f"matmul precision: {jax.config.jax_default_matmul_precision} "
        "(float32, no TF32)")

    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found "
                             f"{len(devices)}")
        phase_four(devices)
        print(result_line(devices[:4]), flush=True)
        return 0

    gpu, cpu = devices[0], jax.devices("cpu")[0]
    phase_a(gpu, cpu)
    phase_b(gpu)
    check_phase_c(*phase_c())
    print(result_line(devices[:1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
