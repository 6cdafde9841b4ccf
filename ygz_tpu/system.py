"""System facade: the public entry point of the SLAM engine.

Mirrors the reference's System class (/root/reference/src/System.cc,
include/System.h): sensor-mode construction, all four per-frame Track*
entry points (MONOCULAR / STEREO / RGBD / MONO_VI) plus the microbatched
track_monocular_batch, trajectory savers (TUM frame/KF, KITTI, NavState),
reset, localization-only mode, and map save/load (the reference's
SaveMap/LoadMap are TODOs, include/System.h:129-131). The reference's
threads are replaced by jitted device stages driven from the host, with the
mapping tail optionally on an async worker (TrackerConfig.async_mapping).
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from .geometry import camera as cam_mod
from .geometry.lie import rotmat_to_quat
from .frontend.tracker import (MonoTracker, RgbdTracker, StereoTracker,
                               TrackerConfig, State)


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    MONO_VI = 3


class System:
    """Facade over the tracking front-end + local mapping back-end.

    Args:
      cam: geometry.camera.Camera (intrinsics + distortion).
      sensor: Sensor mode.
      config: TrackerConfig overrides.
    """

    def __init__(self, cam: cam_mod.Camera, sensor: Sensor = Sensor.MONOCULAR,
                 config: Optional[TrackerConfig] = None, Tbc=None,
                 **vi_kwargs):
        self.cam = cam
        self.sensor = sensor
        if sensor == Sensor.MONOCULAR:
            self.tracker = MonoTracker(cam, config)
        elif sensor == Sensor.RGBD:
            self.tracker = RgbdTracker(cam, config)
        elif sensor == Sensor.STEREO:
            self.tracker = StereoTracker(cam, config)
        elif sensor == Sensor.MONO_VI:
            from .frontend.vi_tracker import MonoViTracker
            self.tracker = MonoViTracker(cam, config, Tbc=Tbc, **vi_kwargs)
        else:
            raise NotImplementedError(
                f"{sensor} lands in a later round; MONOCULAR, STEREO and "
                f"RGBD are implemented")

    # ----------------------------------------------------------- per-frame API
    def track_monocular(self, img, timestamp: float):
        """Process one grayscale (or [H,W] float) frame.

        Returns (state_name, T_cw [4,4]) — world->camera, or identity until
        initialized (reference System::TrackMonocular src/System.cc:356).
        """
        state, R, t = self.tracker.track(img, timestamp)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    def track_monocular_batch(self, imgs, timestamps):
        """Microbatched monocular tracking: chunks of TrackerConfig.
        track_batch frames run as ONE device dispatch (lax.scan), amortizing
        the per-dispatch host<->device cost B-fold — the batched shape of
        the reference's per-frame TrackMonocular loop for offline/dataset
        processing. Returns a list of (state_name, T_cw [4,4]) per frame."""
        out = []
        for state, R, t in self.tracker.track_batch(imgs, timestamps):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = t
            out.append((state.name, T))
        return out

    def track_stereo(self, img_left, img_right, timestamp: float):
        """Stereo entry point (reference System::TrackStereo
        src/System.cc:247): rectified pair; Camera.bf must be set."""
        state, R, t = self.tracker.track(img_left, timestamp,
                                         right=img_right)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    def track_rgbd(self, img, depth, timestamp: float):
        """RGB-D entry point (reference System::TrackRGBD src/System.cc:295):
        `depth` is a metric [H,W] depth map aligned with `img`."""
        state, R, t = self.tracker.track(img, timestamp, depth=depth)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    def track_mono_vi(self, img, imu, timestamp: float):
        """Mono-inertial entry point (reference System::TrackMonoVI
        src/System.cc:86): `imu` is an iterable of (t, gyro[3], acc[3])
        samples since the previous frame."""
        state, R, t = self.tracker.track(img, timestamp, imu=imu)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    # ------------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw of the CAMERA in world frame.
        Poses are recovered by composing each frame's logged relative pose
        onto its reference keyframe's CURRENT (post-BA/loop) pose, walking
        the spanning tree past culled keyframes (reference
        System::SaveTrajectoryTUM src/System.cc:452-508)."""
        with open(path, "w") as f:
            for rec in self.tracker.trajectory:
                if rec.state != "OK":
                    continue
                R, t = self.tracker.recovered_pose(rec)
                Rwc = R.T
                twc = -Rwc @ t
                q = np.asarray(rotmat_to_quat(Rwc))  # [w,x,y,z]
                f.write(f"{rec.ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: one 3x4 row-major [R|t] of T_wc per line
        (reference System::SaveTrajectoryKITTI src/System.cc:544)."""
        with open(path, "w") as f:
            for rec in self.tracker.trajectory:
                R, t = self.tracker.recovered_pose(rec)
                Rwc = R.T
                twc = -Rwc @ t
                vals = np.concatenate(
                    [np.concatenate([Rwc[i], twc[i: i + 1]]) for i in range(3)])
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    def save_keyframe_trajectory_tum(self, path: str):
        smap = self.tracker.map
        with open(path, "w") as f:
            for k in range(smap.n_kf):
                if not smap.kf_valid[k]:
                    continue
                Rwc = smap.kf_R[k].T
                twc = -Rwc @ smap.kf_t[k]
                q = np.asarray(rotmat_to_quat(Rwc))
                f.write(f"{smap.kf_ts[k]:.6f} "
                        f"{twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_keyframe_trajectory_navstate(self, path: str):
        """Mono-VI only: per-keyframe body NavState 'ts px py pz qx qy qz qw
        vx vy vz bgx bgy bgz bax bay baz' (reference
        System::SaveKeyFrameTrajectoryNavState, include/System.h:127)."""
        tr = self.tracker
        kf_ns = getattr(tr, "_kf_ns", None)
        if kf_ns is None:
            raise RuntimeError("NavState trajectory requires the MONO_VI "
                               "tracker after VINS initialization")
        smap = tr.map
        with open(path, "w") as f:
            for k in sorted(kf_ns):
                if k >= smap.n_kf or not smap.kf_valid[k]:
                    continue
                P, V, R_wb = kf_ns[k]
                q = np.asarray(rotmat_to_quat(R_wb))  # [w,x,y,z]
                bg, ba = tr.bg, tr.ba
                vals = [smap.kf_ts[k], *P, q[1], q[2], q[3], q[0], *V,
                        *bg, *ba]
                f.write(" ".join(f"{v:.7f}" for v in vals) + "\n")

    @property
    def trajectory(self):
        return self.tracker.trajectory

    @property
    def map(self):
        return self.tracker.map

    # ------------------------------------------------------------ persistence
    def save_map(self, path: str):
        """Serialize map + place-recognition state to one .npz. (The
        reference never implemented SaveMap — include/System.h:129-131.)"""
        tr = self.tracker
        extra = {}
        if tr.bow_index is not None:
            v = tr.bow_index.vocab
            extra = {"bow_words": v.words, "bow_groups": v.groups,
                     "bow_idf": v.idf,
                     "bow_meta": np.array([v.branching, v.depth], np.int64),
                     "bow_kf_wid": tr.bow_index.kf_wid,
                     "bow_kf_w": tr.bow_index.kf_w,
                     "bow_kf_feat_word": tr.bow_index.kf_feat_word,
                     "bow_kf_valid": tr.bow_index.kf_valid}
            if v.tree_centers is not None and len(v.tree_centers):
                extra.update(bow_tree_centers=v.tree_centers,
                             bow_tree_child=v.tree_child,
                             bow_tree_root=np.int64(v.tree_root))
        with tr._map_lock:
            tr.map.save(path, extra=extra)

    def load_map(self, path: str, localization_only: bool = True):
        """Restore a saved map into the tracker. The session starts LOST and
        re-enters via BoW+PnP relocalization on the first frames; by default
        the map is frozen (localization-only mode)."""
        from .backend.mapstate import SlamMap
        from .backend.bow import Vocabulary, BowIndex
        from .backend.loopclosing import LoopCloser
        from .frontend.tracker import State

        tr = self.tracker
        loaded = SlamMap.load(path)
        if loaded.n_kf == 0 or not loaded.kf_valid[: loaded.n_kf].any():
            raise ValueError(f"{path}: map has no valid keyframes "
                             "(saved before initialization?)")
        tr.map = loaded
        z = np.load(path)
        if "bow_kf_vec" in z or "bow_kf_words" in z:
            # pre-sparse-BoW checkpoint layout (dense [K,W] vectors) —
            # no migration path; fail with a clear message instead of a
            # KeyError deep in the loader (ADVICE r3)
            raise ValueError(
                f"{path}: checkpoint predates the sparse-BoW format "
                "(found dense bow_kf_vec/bow_kf_words keys); re-save the "
                "map with this version to upgrade")
        if "bow_words" in z:
            tree = {}
            if "bow_tree_centers" in z:
                tree = dict(tree_centers=np.array(z["bow_tree_centers"]),
                            tree_child=np.array(z["bow_tree_child"]),
                            tree_root=int(z["bow_tree_root"]))
            vocab = Vocabulary(words=z["bow_words"], groups=z["bow_groups"],
                               idf=z["bow_idf"],
                               branching=int(z["bow_meta"][0]),
                               depth=int(z["bow_meta"][1]), **tree)
            tr.bow_index = BowIndex(vocab, max_kf=len(z["bow_kf_valid"]))
            tr.bow_index.kf_wid = np.array(z["bow_kf_wid"])
            tr.bow_index.kf_w = np.array(z["bow_kf_w"])
            tr.bow_index.kf_feat_word = np.array(z["bow_kf_feat_word"])
            tr.bow_index.kf_valid = np.array(z["bow_kf_valid"])
            tr.loop_closer = LoopCloser(tr.bow_index, tr.cam)
        tr.mapper = tr.mapper  # unchanged; works on the new arrays
        tr.state = State.LOST  # re-enter via relocalization
        tr._last_kf = int(np.nonzero(tr.map.kf_valid[: tr.map.n_kf])[0][-1])
        tr._last_R = np.eye(3, dtype=np.float32)
        tr._last_t = np.zeros(3, np.float32)
        tr._rebuild_cache()
        tr.localization_only = localization_only

    def activate_localization_mode(self):
        """Track against the frozen map, stop mapping (reference
        System::ActivateLocalizationMode src/System.cc:97-125)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """Clear map and tracking state (reference System::Reset)."""
        self.tracker.reset(keep_trajectory=False)

    def shutdown(self):
        """Drain the async mapping worker if one is running (reference
        System::Shutdown joins LocalMapping/LoopClosing, src/System.cc:434)."""
        if getattr(self.tracker, "_map_worker", None) is not None:
            self.tracker.wait_mapping_idle()
