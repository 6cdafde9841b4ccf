"""Shared runner plumbing for the example mains (the reference's Examples/*
per-dataset executables, e.g. mono_euroc_vins.cc)."""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Honor JAX_PLATFORMS even where the env var alone is ignored (an installed
# PJRT plugin can take precedence over it); applying it through jax.config
# makes `JAX_PLATFORMS=cpu python mono_*.py` reliable everywhere.
if os.environ.get("JAX_PLATFORMS"):
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np


def base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("dataset", help="dataset root directory")
    p.add_argument("--settings", default=None, help="YAML settings file")
    p.add_argument("--out", default="trajectory.txt",
                   help="output trajectory (TUM format)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--eval-ate", action="store_true",
                   help="evaluate ATE against dataset ground truth")
    p.add_argument("--timings", action="store_true",
                   help="print per-stage wall-time breakdown + counters")
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="dump frame overlays + final map render to DIR "
                        "(the reference's Pangolin viewer, offline)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard global bundle adjustment over the first N "
                        "devices (landmark-block sharded distributed BA; "
                        "0/1 = single device)")
    p.add_argument("--batch", type=int, default=0,
                   help="microbatch size for tracking (frames per device "
                        "dispatch; 0 = per-frame)")
    return p


def make_viewer(args):
    """DumpViewer when --viz is given, else a no-op."""
    if args.viz:
        from ygz_tpu.viz import DumpViewer
        return DumpViewer(args.viz)

    class _Null:
        def update(self, *a):
            pass

        def finish(self, *a):
            pass
    return _Null()


def load_system(args, sensor, default_cam=None, **kw):
    from ygz_tpu.system import System
    from ygz_tpu.io.config import load_settings

    if args.settings:
        s = load_settings(args.settings)
        cam = s.camera
        cfg = s.tracker
        if s.vio.use_imu and getattr(sensor, "name", "") == "MONO_VI":
            kw.setdefault("Tbc", s.vio.Tbc)
            # the reference reads these from the YAML too
            # (src/IMU/configparam.cpp:11-15)
            kw.setdefault("vins_init_time", s.vio.vins_init_time)
    else:
        cam = default_cam
        cfg = None
    if getattr(args, "devices", 0) and args.devices > 1:
        from ygz_tpu.frontend.tracker import TrackerConfig
        cfg = cfg or TrackerConfig()
        cfg.mesh_devices = args.devices
    if getattr(args, "batch", 0) and args.batch > 1:
        from ygz_tpu.frontend.tracker import TrackerConfig
        cfg = cfg or TrackerConfig()
        cfg.track_batch = args.batch
    return System(cam, sensor, config=cfg, **kw)


class TrackTimer:
    """Median/mean per-frame wall time (the reference prints these at exit,
    mono_euroc_vins.cc:181-190)."""

    def __init__(self):
        self.times = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.times.append(time.perf_counter() - self._t0)

    def report(self):
        t = np.array(self.times[3:] or self.times)  # skip compile frames
        print(f"tracked {len(self.times)} frames: "
              f"median {np.median(t)*1e3:.1f} ms, mean {t.mean()*1e3:.1f} ms")


def maybe_eval_ate(sys_, dataset, args, with_scale):
    if not args.eval_ate or getattr(dataset, "gt", None) is None:
        return
    from ygz_tpu.eval.ate import ate_rmse, associate_timestamps

    gt_ts, gt_xyz = dataset.gt
    est_ts = [r.ts for r in sys_.trajectory if r.state == "OK"]
    est_c = [(-r.R.T @ r.t) for r in sys_.trajectory if r.state == "OK"]
    pairs = associate_timestamps(est_ts, gt_ts)
    if len(pairs) < 10:
        print("ATE: not enough associations")
        return
    est = np.array([est_c[i] for i, _ in pairs])
    gt = np.array([gt_xyz[j] for _, j in pairs])
    rmse, _ = ate_rmse(est, gt, with_scale=with_scale)
    print(f"ATE RMSE: {rmse:.4f} m ({'7' if with_scale else '6'}-DoF aligned,"
          f" {len(pairs)} poses)")
