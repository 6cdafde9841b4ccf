"""ATE accuracy table across all sensor modes on synthetic scenes.

Real EuRoC/TUM/KITTI datasets cannot be fetched in this environment (zero
egress), so the BASELINE ATE targets are held against the hardened synthetic
protocol instead: rendered scenes with photometric nuisances (exposure
gain/bias, pixel noise, motion blur, occluders — utils/synthetic.Nuisance),
evaluated with the same Horn-alignment ATE RMSE the reference's
evaluate_ate_euroc.py uses (eval/ate.py).

Round-4 protocol (VERDICT r3 #5): every mode runs with the BENCH defaults
— async mapping worker ON and (mono) the 8-frame microbatched entry — and
trajectories are exported through recovered_pose (relative-to-keyframe
composition, so BA/loop corrections propagate, matching the reference's
SaveTrajectoryTUM semantics). A 640-frame square-circuit mono sequence with a
real loop closure firing is included.

Usage: JAX_PLATFORMS=cpu python tools/ate_report.py [--out runs/ate_report.md]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import jax  # noqa: E402

# honour JAX_PLATFORMS through jax.config too (as examples/common.py does)
if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# share the repo-local persistent compilation cache (tests/conftest.py)
from ygz_tpu.utils.compile_cache import enable as _enable_cache  # noqa: E402
_enable_cache()


def run_mode(mode, nuisance, n_frames=50):
    import jax.numpy as jnp
    from ygz_tpu.geometry import camera as cam_mod
    from ygz_tpu.system import System, Sensor
    from ygz_tpu.eval.ate import ate_rmse
    from ygz_tpu.utils.synthetic import SmoothScene, StepScene, Nuisance
    from test_vo_e2e import make_trajectory

    from ygz_tpu.frontend.tracker import TrackerConfig

    # '-step' variants run on the terraced multi-depth scene (StepScene):
    # piecewise-constant depth whose terrace edges are occlusion/depth
    # boundaries — the direct tracker's weakest case, measured WITHOUT
    # nuisance overlays (VERDICT r5 #8)
    step = mode.endswith("-step")
    if step:
        mode = mode[: -len("-step")]
    scene = (StepScene if step else SmoothScene)(seed=11)
    nuis = Nuisance(seed=3) if nuisance else None
    poses = make_trajectory(n_frames)
    BASELINE_M = 0.2
    # bench-default configuration: async mapping tail + 8-frame microbatch
    cfg = TrackerConfig(async_mapping=True, track_batch=8)

    if mode == "mono":
        cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                  scene.w, scene.h)
        sys_ = System(cam, Sensor.MONOCULAR, config=cfg)
    elif mode == "mono-loop":
        return run_mono_loop(nuisance)
    elif mode == "stereo":
        cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                  scene.w, scene.h, bf=scene.f * BASELINE_M)
        sys_ = System(cam, Sensor.STEREO, config=cfg)
    elif mode == "rgbd":
        cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                  scene.w, scene.h)
        sys_ = System(cam, Sensor.RGBD, config=cfg)
    elif mode == "mono-vi":
        from test_vio_e2e import pose_fn, synth_imu, FPS
        from ygz_tpu.frontend.tracker import TrackerConfig
        cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                  scene.w, scene.h)
        sys_ = System(cam, Sensor.MONO_VI,
                      config=TrackerConfig(kf_max_gap=8,
                                           async_mapping=True),
                      vins_init_kfs=6, vins_init_time=1.2)
        states = []
        for i in range(70):
            t = i / FPS
            R, tt = pose_fn(t)
            img = scene.render(R, tt)
            if nuis is not None:
                img = nuis.apply(img, i)
            imu = synth_imu((i - 1) / FPS, t) if i > 0 else []
            state, _ = sys_.track_mono_vi(img, imu, timestamp=t)
            states.append(state)
        sys_.shutdown()
        est, gt = [], []
        for i, rec in enumerate(sys_.trajectory):
            if rec.state != "OK":
                continue
            Rr, tr_ = sys_.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr_)
            R, tt = pose_fn(i / FPS)
            gt.append(-R.T @ tt)
        rmse, _ = ate_rmse(np.array(est), np.array(gt), with_scale=False)
        ok = sum(1 for s in states if s == "OK")
        return rmse, ok, len(states), "6-DoF (metric after VINS init)"

    states = []
    buf_img, buf_ts = [], []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        if nuis is not None:
            img = nuis.apply(img, i)
        if mode == "mono":
            # microbatched entry — the bench default (VERDICT r3 #5)
            buf_img.append(img)
            buf_ts.append(i * 0.05)
            if len(buf_img) == 8:
                for st, _T in sys_.track_monocular_batch(buf_img, buf_ts):
                    states.append(st)
                buf_img, buf_ts = [], []
            continue
        elif mode == "stereo":
            tr = t - np.array([BASELINE_M, 0.0, 0.0], np.float32)
            imgR = scene.render(R, tr)
            if nuis is not None:
                imgR = nuis.apply(imgR, 10000 + i)
            state, _ = sys_.track_stereo(img, imgR, timestamp=i * 0.05)
        else:
            depth = scene.depth(R, t)
            state, _ = sys_.track_rgbd(img, depth, timestamp=i * 0.05)
        states.append(state)
    for im, ts_ in zip(buf_img, buf_ts):
        state, _ = sys_.track_monocular(im, timestamp=ts_)
        states.append("OK" if str(state).endswith("OK") else str(state))
    sys_.shutdown()

    from ygz_tpu.eval.ate import ate_rmse
    est, gt = [], []
    for rec, (R, t) in zip(sys_.trajectory, poses):
        if rec.state != "OK":
            continue
        Rr, tr_ = sys_.tracker.recovered_pose(rec)
        est.append(-Rr.T @ tr_)
        gt.append(-R.T @ t)
    with_scale = mode == "mono"
    rmse, _ = ate_rmse(np.array(est), np.array(gt), with_scale=with_scale)
    ok = sum(1 for s in states if str(s).endswith("OK"))
    align = "7-DoF (mono scale)" if with_scale else "6-DoF (metric)"
    return rmse, ok, len(poses), align


def run_mono_loop(nuisance, n_frames=640):
    """640-frame SQUARE CIRCUIT over the scene: four legs long enough that
    the legs do not share view frustums, so the final approach to the start
    is covisibility-DISCONNECTED from the recent chain and re-binds the
    start region only through place recognition — a real loop closure must
    FIRE and the post-correction trajectory is evaluated (VERDICT r3 #5).
    (An out-and-back sweep does NOT loop-close here or in the reference:
    the turn keeps the same surface in view, covisibility never breaks,
    and candidates are excluded as covisible neighbours.)"""
    import jax.numpy as jnp
    from ygz_tpu.geometry import camera as cam_mod, lie
    from ygz_tpu.system import System, Sensor
    from ygz_tpu.frontend.tracker import TrackerConfig
    from ygz_tpu.eval.ate import ate_rmse
    from ygz_tpu.utils.synthetic import SmoothScene, Nuisance

    # texture must cover the full D x D circuit + view span
    scene = SmoothScene(seed=11, tex_size=2400)
    nuis = Nuisance(seed=3) if nuisance else None
    cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                              scene.w, scene.h)
    cfg = TrackerConfig(async_mapping=True, track_batch=8)
    sys_ = System(cam, Sensor.MONOCULAR, config=cfg)

    D = 11.0                      # leg length in world units (view spans ~7)
    leg = n_frames // 4
    corners = [(0.0, 0.0), (D, 0.0), (D, D), (0.0, D), (0.0, 0.0)]

    def pose(i):
        l = min(i // leg, 3)
        a = (i - l * leg) / leg
        x0, y0 = corners[l]
        x1, y1 = corners[l + 1]
        yaw = 0.05 * np.sin(i * 0.11)
        R = np.asarray(lie.so3_exp(jnp.asarray(
            np.array([0.02 * np.sin(i * 0.07), yaw, 0.0], np.float32))))
        c = np.array([x0 + (x1 - x0) * a, y0 + (y1 - y0) * a,
                      0.15 * np.sin(i * 0.05)], np.float32)
        return R, (-R @ c).astype(np.float32)

    poses = [pose(i) for i in range(n_frames)]
    buf_img, buf_ts = [], []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        if nuis is not None:
            img = nuis.apply(img, i)
        buf_img.append(img)
        buf_ts.append(i * 0.05)
        if len(buf_img) == 8:
            sys_.track_monocular_batch(buf_img, buf_ts)
            buf_img, buf_ts = [], []
    for im, ts_ in zip(buf_img, buf_ts):
        sys_.track_monocular(im, timestamp=ts_)
    sys_.shutdown()

    est, gt = [], []
    for rec, (R, t) in zip(sys_.trajectory, poses):
        if rec.state != "OK":
            continue
        Rr, tr_ = sys_.tracker.recovered_pose(rec)
        est.append(-Rr.T @ tr_)
        gt.append(-R.T @ t)
    rmse, _ = ate_rmse(np.array(est), np.array(gt), with_scale=True)
    n_loops = sys_.tracker.n_loops_closed
    align = f"7-DoF; loops closed: {n_loops}"
    if n_loops < 1:
        align += " (NO LOOP FIRED)"
    return rmse, len(est), n_frames, align


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                  "ate_report.md"))
    ap.add_argument("--vi-runs", type=int, default=6,
                    help="repetitions of the nuisanced mono-vi row (its "
                         "async worker timing is host-load dependent; r4 "
                         "measured a bimodal 0.012-115 range — report ALL "
                         "runs, VERDICT r5 #3)")
    ap.add_argument("--modes", default="mono,mono-step,mono-loop,stereo,"
                    "rgbd,rgbd-step,mono-vi")
    args = ap.parse_args()

    rows = []
    for mode in args.modes.split(","):
        for nuisance in (False, True):
            if mode.endswith("-step") and nuisance:
                continue   # step rows isolate depth-discontinuity effects
            reps = args.vi_runs if (mode == "mono-vi" and nuisance) else 1
            rmses = []
            for rep in range(reps):
                t0 = time.time()
                rmse, ok, n, align = run_mode(mode, nuisance)
                rmses.append(rmse)
                print(f"{mode:10s} nuis={nuisance} run {rep + 1}/{reps}: "
                      f"ATE {rmse:.4f}  ({ok}/{n} OK, "
                      f"{time.time() - t0:.0f}s)", flush=True)
            if reps > 1:
                align += (f"; {reps} runs: "
                          + ", ".join(f"{r:.3f}" for r in rmses))
                rmse = float(np.median(rmses))
            rows.append((mode, "yes" if nuisance else "no", rmse, ok, n,
                         align))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# ATE accuracy table (synthetic protocol)\n\n")
        f.write("Real datasets are not fetchable in this environment; this "
                "table gates the BASELINE ATE targets on rendered scenes "
                "with photometric nuisances (tools/ate_report.py; Horn-"
                "aligned ATE RMSE as in the reference's "
                "evaluate_ate_euroc.py). All modes run with the bench "
                "defaults (async mapping + 8-frame microbatch for mono); "
                "poses are exported post-correction via recovered_pose. "
                "mono-loop = 640-frame square circuit (4 x 11-unit legs) "
                "closed by a live loop closure. Trajectory span ~1.5 "
                "world units (~scene depth 5) for the 50-frame rows.\n\n")
        f.write("'-step' rows run on the terraced multi-depth StepScene "
                "(depth discontinuities / occlusion boundaries at terrace "
                "edges — the direct tracker's weakest geometry, clean "
                "renders). The nuisanced mono-vi row reports ALL repeated "
                "runs (its async timing is host-load dependent).\n\n")
        f.write("| mode | nuisances | ATE RMSE | frames OK | alignment |\n")
        f.write("|---|---|---|---|---|\n")
        for mode, nu, rmse, ok, n, align in rows:
            f.write(f"| {mode} | {nu} | {rmse:.4f} | {ok}/{n} | {align} |\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
