"""Ahead-of-time compile warmup (SURVEY §7.3: "the reference 'loads
vocabulary' at startup; we 'compile kernels'").

Every steady-state device program is compiled by driving a short synthetic
sequence through a SCRATCH System built with the SAME camera + config as the
production one — identical shapes and jit statics (intrinsics are static
args), so the production System hits only compile caches. With the
persistent compilation cache enabled (jax_compilation_cache_dir), later
processes skip the compiles too. A compile stalls the caller for seconds
per program; warmup pulls all of them to startup, before the real-time
loop starts.
"""
from __future__ import annotations

import time

import numpy as np


def warmup_tracking(cam, cfg=None, n_frames: int = 26,
                    verbose: bool = False) -> float:
    """Compile the monocular tracking + mapping-tail programs for (cam,
    cfg). Drives a synthetic textured-plane sequence at the camera's exact
    resolution/intrinsics through a scratch System: two-view init, fused
    per-frame steps, microbatched steps (cfg.track_batch), keyframe
    creation, triangulation, fusion, local BA, culling and BoW indexing all
    trace + compile here. Returns elapsed seconds."""
    from .system import System, Sensor
    from .frontend.tracker import TrackerConfig
    from .utils.synthetic import SmoothScene

    t0 = time.perf_counter()
    cfg = cfg or TrackerConfig()
    import dataclasses
    scratch_cfg = dataclasses.replace(cfg, async_mapping=False)
    scene = SmoothScene(seed=3, w=cam.width, h=cam.height, f=cam.fx,
                        tex_size=1400)
    sys_ = System(cam, Sensor.MONOCULAR, config=scratch_cfg)

    def pose(i):
        # gentle sideways sweep with yaw wobble: initializes by frame ~2,
        # creates several keyframes over n_frames
        yaw = 0.02 * np.sin(i * 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = -R @ np.array([0.04 * i, 0.0, 0.0], np.float32)
        return R, t

    # uint8 frames: the camera-native format, and 4x fewer bytes to upload
    # than float32 (frame_step casts on device)
    frames = [np.clip(scene.render(*pose(i), backend="numpy"), 0,
                      255).astype(np.uint8)
              for i in range(n_frames)]
    ts = [i * 0.05 for i in range(n_frames)]
    t_render = time.perf_counter() - t0
    B = max(1, scratch_cfg.track_batch)
    # per-frame path first (bootstrap + fused single-frame program) ...
    t1 = time.perf_counter()
    k = min(max(6, B), n_frames)
    for i in range(k):
        sys_.track_monocular(frames[i], ts[i])
    t_single = time.perf_counter() - t1
    # ... then the microbatched program
    t1 = time.perf_counter()
    if B > 1:
        i = k
        while i + B <= n_frames:
            sys_.track_monocular_batch(frames[i: i + B], ts[i: i + B])
            i += B
    # failure-path programs (feature-fallback ladder, relocalization):
    # the clean sweep never fails, so these only trace here EXPLICITLY —
    # their first compile/load landing mid-benchmark was the r4/r5
    # "big_compiles on a compile-clean run" stall (the r4 attempt of
    # forcing failures with blank frames RESET the scratch map;
    # warm_failure_paths runs the same programs without failing anything)
    sys_.tracker.warm_failure_paths()
    sys_.shutdown()
    t_batch = time.perf_counter() - t1
    dt = time.perf_counter() - t0
    if verbose:
        st = sys_.tracker.stats()
        print(f"warmup: {n_frames} frames, {st['n_kf']} KFs in {dt:.1f}s "
              f"(scene+render {t_render:.1f}s, per-frame path "
              f"{t_single:.1f}s, batched path {t_batch:.1f}s)")
    return dt


def main(argv=None):
    """CLI used by bench.py to run the compile warmup in a SUBPROCESS: the
    compiles populate the shared persistent compilation cache, and the
    timed process then loads pure cache hits."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=752)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--focal", type=float, default=458.0)
    p.add_argument("--batch", type=int, default=8)
    a = p.parse_args(argv)

    from .utils.compile_cache import enable
    enable()

    from .geometry import camera as cam_mod
    from .frontend.tracker import TrackerConfig

    cam = cam_mod.Camera.make(a.focal, a.focal, a.width / 2.0 - 0.5,
                              a.height / 2.0 - 0.5, a.width, a.height)
    cfg = TrackerConfig(async_mapping=False, track_batch=a.batch)
    # enough frames for the bootstrap (warmup_tracking consumes
    # max(6, batch) frames on the per-frame path) PLUS two full
    # microbatches — otherwise the batched program never traces here and
    # first-compiles mid-benchmark
    dt = warmup_tracking(cam, cfg,
                         n_frames=max(6, a.batch) + 2 * a.batch,
                         verbose=True)
    print(f"warmup subprocess done in {dt:.1f}s")


if __name__ == "__main__":
    main()
