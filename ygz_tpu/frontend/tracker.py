"""Monocular tracking front-end: host state machine over jitted device steps.

Re-design of the reference Tracking thread (/root/reference/src/Tracking.cc
:399-738): the same pipeline — initialize -> predict pose (sparse direct
alignment seeded by a motion model) -> direct local-map tracking with a point
cache -> pose-only GN -> keyframe decision — but with all numerics as a few
batched jitted megafunctions and all map state functional (no map-wide mutex;
the reference holds Map::mMutexMapUpdate for the whole Track() call,
src/Tracking.cc:407).

Per-frame device work: build pyramid; sparse_image_align; track_local_map
(warp + KLT + pose GN). Host work is O(#points) bookkeeping in numpy.
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..backend.mapstate import SlamMap
from ..backend.mapping import LocalMapper
from ..backend.bow import train_vocabulary, BowIndex
from ..backend.loopclosing import LoopCloser
from ..backend.optim import pose_optimization
from ..backend.pnp import pnp_ransac
from ..geometry import camera as cam_mod
from ..geometry.twoview import two_view_reconstruct
from ..ops import matching, select
from ..ops.image import build_pyramid
from .extractor import OrbExtractor, describe_at
from .sparse_align import sparse_image_align
from .direct_tracker import capture_ref_patches  # noqa: F401 (re-export)
from .framestep import (frame_step, frame_step_batch, make_carry,
                        unpack_out, unstack_pyramid, pack_cache_np,
                        pack_pred_np, build_pyramid_stacked)


def _device_put_block(a):
    """Upload one array slice and wait for it (runs on a pool thread, so
    several slices' uploads overlap)."""
    d = jnp.asarray(a)
    jax.block_until_ready(d)
    return d


@jax.jit
def _concat_chunks(*parts):
    """Reassemble split-uploaded image slices device-side (one dispatch)."""
    return jnp.concatenate(parts, axis=0)


class State(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerConfig:
    n_features: int = 512
    keypoint_mode: str = "grid"   # 'grid' (DSO selector) | 'octree'
    n_levels: int = 4
    scale_factor: float = 2.0
    fast_th: float = 20.0
    fast_th_min: float = 7.0
    max_track: int = 512          # direct-tracking cache capacity
    cache_refill_below: int = 150  # reference Tracking.CacheFeatures default
    min_align_points: int = 30    # reference needs >=30 to sparse-align
    min_track_inliers: int = 30   # TrackLocalMap success gate
    min_init_matches: int = 100   # monocular init gate (reference :842)
    kf_ratio: float = 0.75        # c2: inliers < 0.75 * ref-KF tracked
    kf_min_gap: int = 3           # min frames between KFs
    kf_max_gap: int = 30          # force KF after this many frames
    th_depth: float = 35.0        # close/far split in baseline units
    #                               (mThDepth = bf/fx * ThDepth, reference
    #                               src/Tracking.cc:252-258)
    ba_window: int = 6
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    vocab_branching: int = 8
    vocab_depth: int = 3
    # "auto": load the shipped offline vocabulary (ygz_tpu/data/
    # orb_vocab.npz, k=10 L=5, 99,478 words — the analog of the reference
    # loading ORBvoc.bin at startup, src/System.cc:186-191) when present,
    # else train in-system on the init descriptors. A path loads that file;
    # None forces in-system training.
    vocab_path: Optional[str] = "auto"
    # run the mapping tail (triangulation, fusion, BA, culling, loop
    # closing) on a background thread — the async counterpart of the
    # reference's LocalMapping thread. Tracking then returns the pre-BA
    # frame pose; BA corrections land through the shared map under a lock.
    async_mapping: bool = False
    # microbatch size for track_batch(): B consecutive frames per device
    # dispatch (one upload + execute + readback per chunk). 1 = per-frame.
    track_batch: int = 8
    # chunks kept in flight by track_batch: chunk N+1 depends only on the
    # device-resident carry, so it is dispatched BEFORE chunk N's readback
    # is consumed, and the readback wait of one chunk overlaps the next
    # chunk's upload + execute; keyframe/mapping effects lag one extra
    # chunk (same contract as the in-chunk B-1 frame lag). 1 = serial
    # dispatch-consume (round-4 behavior).
    pipeline_depth: int = 2
    # distributed bundle adjustment: shard global BA over the first N
    # devices (landmark-block sharding, parallel/dist_ba.py). 0/1 = single
    # device. This is the product plumbing for the multi-chip capability
    # the reference lacks (SURVEY §2.4) — e.g. examples/mono_euroc.py
    # --devices N.
    mesh_devices: int = 0


@dataclass
class FrameRecord:
    """Per-frame trajectory log entry. R/t is the live world->cam estimate
    at track time; ref_kf + (R_r, t_r) store the pose RELATIVE to the
    reference keyframe (the reference's mlRelativeFramePoses,
    include/Tracking.h:108-114) so later map optimizations (local/global BA,
    loop correction) propagate into the exported trajectory."""
    ts: float
    R: np.ndarray
    t: np.ndarray
    state: str
    ref_kf: int = -1
    R_r: np.ndarray = None
    t_r: np.ndarray = None


class MonoTracker:
    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None):
        self.cam = cam
        self.cfg = cfg or TrackerConfig()
        self.intr = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.extractor = OrbExtractor(
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale_factor=self.cfg.scale_factor, fast_th=self.cfg.fast_th,
            fast_th_min=self.cfg.fast_th_min, mode=self.cfg.keypoint_mode)
        self.map = SlamMap(max_feat=1024)
        mesh = None
        if self.cfg.mesh_devices and self.cfg.mesh_devices > 1:
            from jax.sharding import Mesh
            devs = jax.devices()
            if len(devs) < self.cfg.mesh_devices:
                raise ValueError(
                    f"mesh_devices={self.cfg.mesh_devices} but only "
                    f"{len(devs)} devices visible")
            mesh = Mesh(np.array(devs[: self.cfg.mesh_devices]), ("obs",))
        self.mapper = LocalMapper(cam, n_levels=self.cfg.n_levels,
                                  window=self.cfg.ba_window, mesh=mesh)
        self.state = State.NOT_INITIALIZED
        self.frame_id = -1
        self.trajectory: list[FrameRecord] = []

        # undistortion remap, stacked [2,H,W] = ONE device buffer (None when
        # the camera has no distortion)
        if float(np.abs(np.asarray(cam.dist)).sum()) > 0:
            mu, mv = cam_mod.undistort_remap_grid(cam)
            self._remap = jnp.stack([jnp.asarray(mu), jnp.asarray(mv)])
        else:
            self._remap = None

        # init bootstrap state
        self._init_feats = None
        self._init_pyr = None
        self._init_ts = None

        # last-frame state for sparse alignment
        self._last_pyr = None
        self._last_R = None
        self._last_t = None
        self._last_uv = None        # [max_track,2] tracked uv (level-0)
        self._last_Xc = None        # [max_track,3] points in last cam frame
        self._last_valid = None
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

        self._cache = np.zeros(0, np.int64)   # map point ids in direct cache
        self._cache_dev = None                # device snapshot of their state
        # lock-free published tracking snapshot: (cache ids, device cache,
        # ref kf id, ref kf pose). The tracking hot path reads ONLY this
        # (one atomic attribute read); the mapping tail republishes it after
        # commits — tracking never contends on the map lock per frame.
        self._snap = None
        # device-resident per-frame carry (framestep.FrameCarry)
        self._carry = None
        self.debug = {}
        from ..utils.profiling import StageTimer
        self.timer = StageTimer()   # per-stage wall-clock (SURVEY §5 gap)
        # image-upload workers: chunk uploads split + overlapped with the
        # chunks still in flight
        self._upload_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="ygz-upload")
        # place recognition: vocabulary trained in-system at map init
        self.bow_index: BowIndex = None
        self.loop_closer: LoopCloser = None
        self.n_loops_closed = 0
        self._last_kf = -1
        self._last_kf_frame = -1
        self._kf_ref_tracked = 0
        self._rng = jax.random.PRNGKey(0)
        # localization-only: track against the frozen map, no KFs/mapping
        # (reference ActivateLocalizationMode, src/System.cc:97-125)
        self.localization_only = False

        # async mapping pipeline (reference: LocalMapping thread,
        # src/System.cc:221-222). The map lock replaces the reference's
        # Map::mMutexMapUpdate but is held only for array reads/commits,
        # never across device computation.
        self._map_lock = threading.RLock()
        self._map_queue: queue.Queue = queue.Queue()
        self._map_worker = None
        self._map_worker_error = None
        if self.cfg.async_mapping:
            self._map_worker = threading.Thread(
                target=self._mapping_worker, daemon=True)
            self._map_worker.start()

    def _mapping_worker(self):
        # bind the queue once: reset() swaps self._map_queue for a fresh
        # one while this (old) thread may be mid-job — re-reading the
        # attribute in `finally` would task_done() the NEW queue and
        # corrupt its join() accounting
        q = self._map_queue
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            try:
                job()
            except Exception as e:  # surfaced via wait_mapping_idle
                self._map_worker_error = e
            finally:
                q.task_done()

    def wait_mapping_idle(self):
        """Block until the background mapping queue drains."""
        self._map_queue.join()
        if self._map_worker_error is not None:
            err = self._map_worker_error
            self._map_worker_error = None
            raise err

    def reset(self, keep_trajectory: bool = True):
        """Clear map and tracking state (reference Tracking::Reset,
        src/Tracking.cc:1980-2028)."""
        traj = self.trajectory if keep_trajectory else []
        # bake relative-pose records to absolute against the dying map —
        # their ref_kf ids would otherwise dangle into the NEW map
        for rec in traj:
            if rec.ref_kf >= 0:
                rec.R, rec.t = self.recovered_pose(rec)
                rec.ref_kf, rec.R_r, rec.t_r = -1, None, None
        fid = self.frame_id
        # stop the OLD mapping worker: __init__ creates a fresh queue +
        # thread; without the sentinel the old thread would idle forever
        # on the dead queue (pending old-map jobs drain first and drop
        # themselves via the map-swap guards)
        if getattr(self, "_map_worker", None) is not None:
            self._map_queue.put(None)
        self.__init__(self.cam, self.cfg)
        self.trajectory = traj
        self.frame_id = fid

    # ------------------------------------------------------------------ utils
    def _build_pyramid(self, img):
        """Pyramid (+ optional undistort) as ONE jitted dispatch returning
        the SINGLE stacked buffer — all pyramid consumers (extractor, patch
        capture, carry rebuild, triangulation) are stacked-aware, so no
        per-level transfers or eager slices ever happen."""
        self.timer.dispatches["pyramid"] += 1
        return build_pyramid_stacked(jnp.asarray(img), self._remap,
                                     self.cfg.n_levels,
                                     self.cfg.scale_factor)

    def _unstack(self, pyr_stack):
        return unstack_pyramid(pyr_stack, self.cfg.n_levels,
                               self.cfg.scale_factor,
                               height=self.cam.height)

    def _pose_np(self, R, t):
        return np.asarray(R), np.asarray(t)

    # ------------------------------------------------------------------ entry
    def track(self, img, ts: float, depth=None):
        """Process one grayscale frame. Returns (state, R, t) with (R,t) the
        world->camera pose estimate (identity until initialized).
        `depth`: optional [H,W] metric depth map (RGB-D mode)."""
        self.frame_id += 1
        self._cur_depth = depth

        if self.state == State.NOT_INITIALIZED:
            with self.timer.stage("pyramid"):
                pyr = self._build_pyramid(img)
            ok = self._try_initialize(pyr, ts)
            R = self.map.kf_R[self.map.n_kf - 1] if ok else np.eye(3)
            t = self.map.kf_t[self.map.n_kf - 1] if ok else np.zeros(3)
            self._log(ts, R, t)
            return self.state, R, t

        if self.state == State.LOST:
            with self.timer.stage("pyramid"):
                pyr = self._build_pyramid(img)
            if self.cfg.enable_relocalization and self._relocalize(pyr):
                self.state = State.OK
            else:
                self._log(ts, self._last_R, self._last_t)
                return self.state, self._last_R, self._last_t

        ok, R, t = self._track_frame(img, ts)
        self._log(ts, R, t)
        return self.state, R, t

    def _log(self, ts, R, t):
        R = np.array(R, np.float32)
        t = np.array(t, np.float32)
        ref, R_r, t_r = -1, None, None
        snap = self._snap
        if self.state == State.OK and snap is not None and snap[2] >= 0:
            # relative pose against the ref KF pose AS TRACKED AGAINST (the
            # published snapshot): recovery composes onto the KF's future
            # pose, so BA/loop corrections propagate into the trajectory
            ref, Rk, tk = snap[2], snap[3], snap[4]
            # T_cr = T_cw(frame) * inv(T_cw(ref))
            R_r = R @ Rk.T
            t_r = t - R_r @ tk
        self.trajectory.append(FrameRecord(
            ts=ts, R=R, t=t, state=self.state.name,
            ref_kf=ref, R_r=R_r, t_r=t_r))

    def recovered_pose(self, rec: FrameRecord):
        """Frame pose with all post-hoc map corrections applied: compose the
        logged relative pose onto the ref KF's CURRENT pose, walking the
        spanning tree past culled KFs (reference System::SaveTrajectoryTUM,
        src/System.cc:452-508)."""
        if rec.ref_kf < 0 or rec.R_r is None:
            return rec.R, rec.t
        with self._map_lock:
            Rk, tk = self.map.resolve_pose(rec.ref_kf)
        return rec.R_r @ Rk, rec.R_r @ tk + rec.t_r

    def _build_vocabulary(self, desc, doc_ids=None):
        """Vocabulary source dispatch (see TrackerConfig.vocab_path): load
        the shipped offline vocabulary or train in-system on `desc`."""
        import os
        from ..backend.bow import (load_vocabulary, default_vocabulary_path,
                                   train_vocabulary)
        path = self.cfg.vocab_path
        if path == "auto":
            p = default_vocabulary_path()
            if os.path.exists(p):
                return load_vocabulary(p)
        elif path:
            return load_vocabulary(path)
        return train_vocabulary(desc, branching=self.cfg.vocab_branching,
                                depth=self.cfg.vocab_depth, doc_ids=doc_ids)

    @staticmethod
    def _feats_to_dict(feats):
        f = jax.tree.map(np.asarray, feats)
        return {"uv": f.uv, "level": f.level, "angle": f.angle,
                "desc": f.desc, "valid": f.valid}

    # ----------------------------------------------------------------- init
    def _try_initialize(self, pyr, ts) -> bool:
        feats = self.extractor(pyr)
        if self._init_feats is None:
            if int(np.asarray(feats.valid).sum()) >= self.cfg.min_init_matches:
                self._init_feats = self._feats_to_dict(feats)
                self._init_pyr = pyr
                self._init_ts = ts
            return False

        f0, f1 = self._init_feats, feats
        idx, ok = matching.match_with_windows(
            jnp.asarray(f0["desc"]), jnp.asarray(f0["valid"]),
            f1.desc, f1.valid,
            uv_pred1=jnp.asarray(f0["uv"]), uv2=f1.uv, radius=100.0,
            max_dist=matching.TH_LOW, ratio=0.9,
            ang1=jnp.asarray(f0["angle"]), ang2=f1.angle, mutual=True)
        idx = np.asarray(idx)
        okm = np.asarray(ok)
        n_matches = int(okm.sum())
        if n_matches < self.cfg.min_init_matches:
            # stale reference: restart bootstrapping from this frame
            self._init_feats = self._feats_to_dict(feats)
            self._init_pyr = pyr
            self._init_ts = ts
            return False

        uv1 = f0["uv"]
        uv2 = np.asarray(f1.uv)[np.clip(idx, 0, len(np.asarray(f1.uv)) - 1)]
        self._rng, key = jax.random.split(self._rng)
        res = two_view_reconstruct(
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(okm),
            jnp.asarray(self.cam.K), key)
        if not bool(res.ok):
            return False

        self._create_initial_map(res, idx, feats, pyr, ts)
        return True

    def _create_initial_map(self, res, idx, feats1, pyr1, ts1):
        """Two KFs + triangulated points; scale so median depth = 1
        (reference CreateInitialMapMonocular src/Tracking.cc:863)."""
        good = np.asarray(res.good)
        X = np.asarray(res.points)          # in cam0 frame == world
        R1 = np.asarray(res.R)
        t1 = np.asarray(res.t)
        med = float(np.median(X[good][:, 2]))
        X = X / med
        t1 = t1 / med

        f0 = self._init_feats
        smap = self.map
        kf0 = smap.add_keyframe(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), f0,
                                ts=self._init_ts, frame_id=self.frame_id - 1,
                                pyramid=self._init_pyr)
        kf1 = smap.add_keyframe(R1, t1, self._feats_to_dict(feats1), ts=ts1,
                                frame_id=self.frame_id, pyramid=pyr1)

        slots0 = np.nonzero(good)[0]
        slots1 = idx[slots0]
        # only keep points whose reference patch (captured from KF1) is clean
        inb = self.mapper.patch_in_bounds(
            smap.kf_feat_uv[kf1, slots1], smap.kf_feat_level[kf1, slots1])
        slots0 = slots0[inb]
        slots1 = slots1[inb]
        ids = smap.alloc_points(len(slots0))
        smap.pt_xyz[ids] = X[slots0]
        smap.pt_valid[ids] = True
        smap.pt_first_kf[ids] = kf0
        smap.pt_desc[ids] = f0["desc"][slots0]
        smap.bind(kf0, slots0, ids)
        smap.bind(kf1, slots1, ids)
        self.mapper.refresh_patches(smap, kf1, pyr1, ids, slots1)

        # initial bundle adjustment over the 2-KF map
        self.mapper.local_ba(smap, kf1)
        # re-normalize scale after BA (BA may drift the free scale gauge)
        med2 = self.mapper.median_depth(smap, kf0)
        smap.pt_xyz[: smap.n_pt] /= med2
        smap.kf_t[:2] /= med2
        self.mapper.refresh_patches(smap, kf1, pyr1, ids, slots1)

        # place-recognition vocabulary: shipped offline vocab when present,
        # in-system training on the initial descriptors as fallback
        if self.cfg.enable_loop_closing or self.cfg.enable_relocalization:
            desc = np.concatenate([
                f0["desc"][f0["valid"]],
                self._feats_to_dict(feats1)["desc"][np.asarray(feats1.valid)]])
            doc = np.concatenate([
                np.zeros(int(f0["valid"].sum()), np.int64),
                np.ones(int(np.asarray(feats1.valid).sum()), np.int64)])
            vocab = self._build_vocabulary(desc, doc)
            self.bow_index = BowIndex(vocab, max_kf=smap.max_kf)
            self.loop_closer = LoopCloser(self.bow_index, self.cam)
            for k in (kf0, kf1):
                wid, bow = self.bow_index.quantize(
                    smap.kf_feat_desc[k], smap.kf_feat_valid[k])
                self.bow_index.add_keyframe(k, bow, feat_wid=wid)

        smap.kf_parent[kf1] = kf0
        self.state = State.OK
        self._last_kf = kf1
        self._last_kf_frame = self.frame_id
        self._kf_ref_tracked = len(ids)
        self._rebuild_cache()
        self._set_last_frame(pyr1, smap.kf_R[kf1], smap.kf_t[kf1],
                             cache_uv=None)
        R0, t0 = smap.kf_R[kf0], smap.kf_t[kf0]
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        del R0, t0

    # ------------------------------------------------------------- main track
    def _track_frame(self, img, ts):
        """Steady-state tracked frame: ONE fused device dispatch + ONE small
        readback (framestep.frame_step). The sparse alignment, direct
        local-map tracking and velocity update all run device-resident; the
        host only does O(#points) numpy bookkeeping on the readback."""
        cfg = self.cfg
        smap = self.map

        # external pose prediction hook (mono-VI: IMU propagation,
        # reference PredictNavStateByIMU src/Tracking.cc:2078); the fused
        # step falls back to the on-device velocity model otherwise
        pred = self._predict_pose()
        if pred is not None:
            pred_vec = jnp.asarray(pack_pred_np(pred[0], pred[1], True))
        else:
            # device-cached constant: the mono path would otherwise upload
            # an identity pred vector every frame (an extra host->device transfer)
            if not hasattr(self, "_no_pred_dev"):
                self._no_pred_dev = jnp.asarray(pack_pred_np())
            pred_vec = self._no_pred_dev

        # cache refill (lock-free read of the published snapshot; rebuild
        # only when the mapper is idle so we never contend with the tail)
        snap = self._snap
        if len(snap[0]) < cfg.cache_refill_below and self._tail_idle():
            with self._map_lock:
                self._rebuild_cache()
            snap = self._snap
        ids, dev = snap[0], snap[1]
        n = len(ids)

        self.timer.total["frame_step"] -= time.perf_counter()
        self.timer.dispatches["frame_step"] += 1
        self._carry, out = frame_step(
            jnp.asarray(img), self._carry, dev, pred_vec,
            self._remap, self.intr, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, min_align=cfg.min_align_points)
        # ONE device->host transfer (a single packed buffer) for everything
        # this frame needs: each separate readback is one more host sync
        out = unpack_out(np.asarray(out), cfg.max_track)
        self.timer.total["frame_step"] += time.perf_counter()
        self.timer.count["frame_step"] += 1

        # pyr_fn hands out the carry's stacked pyramid — the current
        # frame's, already device-resident, zero extra dispatches
        ok, R, t, _ = self._consume_out(out, ids, ts,
                                        lambda: self._carry.pyr,
                                        snap_xyz=snap[5])
        return ok, R, t

    # ----------------------------------------------------------- batch track
    def track_batch(self, imgs, timestamps):
        """Process consecutive frames with MICROBATCHED, PIPELINED device
        dispatch: chunks of cfg.track_batch frames run as one lax.scan on
        device (framestep.frame_step_batch) — one upload + one execute +
        one readback per chunk — and up to cfg.pipeline_depth chunks stay
        in flight at once. Chunk N+1 depends only on the device-resident
        carry and a cache snapshot, so it is dispatched BEFORE chunk N's
        readback is materialized; the readback wait of chunk N then
        overlaps chunk N+1's upload + execute (VERDICT r5 #1a). Keyframe/mapping effects lag up to B-1 frames in-chunk (the
        reference's async LocalMapping exhibits the same lag) plus up to
        (pipeline_depth-1) chunks of snapshot lag. Bootstrap/LOST/fallback
        frames and any frames after an in-batch tracking failure drop to
        the per-frame path; speculatively dispatched chunks chaining from
        an invalidated carry are discarded unread.

        Returns a list of (state_name, R, t) per frame."""
        cfg = self.cfg
        B = cfg.track_batch
        depth = max(1, cfg.pipeline_depth)
        results = []
        i = 0                  # first frame not yet consumed
        next_i = 0             # first frame not yet dispatched
        n_total = len(imgs)
        inflight = []          # [(i0, snap, outs_dev, pyrs)], oldest first
        pre = {}               # j -> upload futures for chunk starting at j

        def can_batch(j):
            # state/predictor are read at dispatch time: with chunks in
            # flight this speculates that they stay unchanged (clean
            # consumption leaves both as-is; aborts discard speculation)
            return (self.state == State.OK and B > 1 and n_total - j >= B
                    and self._predict_pose() is None)

        def pre_upload(j):
            # the image upload is the chunk's single biggest transfer:
            # split it across pool threads and start it while earlier
            # chunks are still dispatching / being consumed (upload rides
            # under compute)
            if j in pre or n_total - j < B:
                return
            arr = np.stack([np.asarray(f) for f in imgs[j: j + B]])
            parts = np.array_split(arr, 4) if B >= 16 else [arr]
            pre[j] = [self._upload_pool.submit(_device_put_block, p)
                      for p in parts]

        def dispatch(j):
            # backpressure: a chunk never tracks against a snapshot that
            # predates the mapping tails of keyframes already created.
            # Batches run faster than the camera delivers frames; on a GPU
            # the tracker otherwise outran the tail by two chunks, tracked
            # against a starved cache into unmapped view and stayed LOST.
            if self._map_worker is not None:
                self.wait_mapping_idle()
            snap = self._snap
            if (len(snap[0]) < cfg.cache_refill_below and self._tail_idle()):
                with self._map_lock:
                    self._rebuild_cache()
                snap = self._snap
            t0 = time.perf_counter()
            futs = pre.pop(j, None)
            if futs is None:
                arr = np.stack([np.asarray(f) for f in imgs[j: j + B]])
                parts = (np.array_split(arr, 4) if B >= 16 else [arr])
                futs = [self._upload_pool.submit(_device_put_block, p)
                        for p in parts]
            devs = [f.result() for f in futs]
            batch = devs[0] if len(devs) == 1 else _concat_chunks(*devs)
            self._carry, outs, pyrs = frame_step_batch(
                batch, self._carry, snap[1], self._remap, self.intr,
                n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                min_align=cfg.min_align_points)
            self.timer.total["frame_step"] += time.perf_counter() - t0
            self.timer.dispatches["frame_step"] += 1
            return (j, snap, outs, pyrs)

        while i < n_total or inflight:
            while len(inflight) < depth and can_batch(next_i):
                pre_upload(next_i + B)   # overlap next chunk's upload
                inflight.append(dispatch(next_i))
                next_i += B
            if not inflight:
                # per-frame path (bootstrap / LOST / external predictor /
                # short remainder)
                st, R, t = self.track(imgs[i], timestamps[i])
                results.append((st, R, t))
                i += 1
                next_i = i
                continue

            i0, snap, outs_dev, pyrs = inflight.pop(0)
            t0 = time.perf_counter()
            outs = np.asarray(outs_dev)   # ONE [B, packed] readback buffer
            self.timer.total["frame_step"] += time.perf_counter() - t0
            self.timer.count["frame_step"] += B
            ids = snap[0]

            consumed = 0
            for b in range(B):
                self.frame_id += 1
                self._cur_depth = None
                out_b = unpack_out(outs[b], cfg.max_track)

                def pyr_b(b=b):
                    # stacked [SH,W] single buffer; one eager slice
                    return pyrs[b]

                ok, R, t, clean = self._consume_out(
                    out_b, ids, timestamps[i0 + b], pyr_b, batch_mode=True,
                    snap_xyz=snap[5])
                self._log(timestamps[i0 + b], R, t)
                results.append((self.state, R, t))
                consumed += 1
                if not clean:
                    # fallback/loss invalidated the rest of the chunk: the
                    # remaining frames re-run on the per-frame path
                    break
            i = i0 + consumed
            if consumed < B or not clean:
                # the host rewrote the carry (fallback/reloc/reset) — even
                # on the chunk's LAST frame: speculative chunks chained
                # from the invalidated device carry — discard their
                # results unread
                inflight.clear()
                next_i = i
        return results

    def _consume_out(self, out, ids, ts, pyr_fn, batch_mode: bool = False,
                     snap_xyz=None):
        """Host bookkeeping for one tracked frame's readback. `pyr_fn` lazily
        provides the frame's pyramid (only evaluated on keyframe/fallback
        frames). In batch mode the device carry is NOT rewritten on clean
        keyframes (later batch frames were already tracked; the mapping tail
        applies corrections map-side, mirroring the reference's async
        LocalMapping lag); returns (ok, R, t, clean) there, with clean=False
        when the caller must abort the rest of the microbatch."""
        cfg = self.cfg
        smap = self.map
        n = len(ids)
        n_inliers = int(out.n_inliers)
        self.debug = {
            "n_align_in": int(out.n_align_in),
            "align_n": int(out.align_n),
            "align_res": float(out.align_res),
            "n_cache": n,
            "n_visible": int(out.visible[:n].sum()),
            "n_aligned": int(out.tracked[:n].sum()),
            "n_inliers": n_inliers,
        }
        tracked = out.tracked[:n]
        visible = out.visible[:n]
        uv = out.uv[:n]
        lvl = out.level[:n]
        R_pred = out.R_pred
        t_pred = out.t_pred
        self.debug["viz_uv"] = uv[tracked]  # for viz.draw_tracked_frame

        # update found/visible statistics
        np.add.at(smap.pt_visible, ids[visible], 1)
        np.add.at(smap.pt_found, ids[tracked], 1)

        t_ids, t_uv, t_lvl = ids[tracked], uv[tracked], lvl[tracked]
        # world positions of the tracked points AS THE SNAPSHOT SAW THEM
        # (the same geometry the direct tracker aligned against)
        t_xyz = snap_xyz[:n][tracked] if snap_xyz is not None else None
        R_cur, t_cur = out.R, out.t

        recovered = False  # host changed the pose -> carry must be rewritten
        aborted = False    # batch mode: later batch frames are invalid
        if n_inliers < cfg.min_track_inliers:
            pyr = pyr_fn()
            aborted = True
            # feature-method fallback ladder (reference Tracking.cc:563-577:
            # direct local-map failure -> re-extract features -> motion
            # model -> ref-KF -> feature TrackLocalMap; only then LOST)
            fb = self._feature_fallback(pyr, R_pred, t_pred)
            if fb is not None:
                R_cur, t_cur, t_ids, t_uv, t_lvl = fb
                t_xyz = None   # fallback matches are not snapshot-aligned
                n_inliers = len(t_ids)
                recovered = True
                self.debug["n_inliers_feat"] = n_inliers
                np.add.at(smap.pt_found, t_ids, 1)
                np.add.at(smap.pt_visible, t_ids, 1)
            elif self._on_vision_failed(pyr, ts, R_pred, t_pred):
                # IMU-only fallback kept the state alive (vision-weak mode,
                # reference src/Tracking.cc:684-698) — unless the subclass
                # escalated to relocalization and recovered a DIFFERENT
                # pose (bounded dead-reckoning, VERDICT r5 #3), in which
                # case the tracking state was already rebuilt there
                rp = getattr(self, "_recovered_pose_override", None)
                if rp is not None:
                    self._recovered_pose_override = None
                    return True, rp[0], rp[1], False
                self._set_last_frame(pyr, R_pred, t_pred, cache_uv=None)
                return True, R_pred, t_pred, False
            else:
                last_R = self._last_R
                last_t = self._last_t
                self.state = State.LOST
                # reset-on-early-loss: a map of <=5 KFs is not worth
                # relocalizing against (reference src/Tracking.cc:703-711)
                if smap.n_kf <= 5 and not self.localization_only:
                    self.reset()
                    self.state = State.NOT_INITIALIZED
                return False, last_R, last_t, False
        # sensor-fusion hook (mono-VI: NavState optimization with the
        # tracked observations + preintegration factor)
        fused = self._fuse_pose(R_cur, t_cur, t_ids, t_uv, t_lvl,
                                xyz=t_xyz)
        if fused is not None:
            R_cur, t_cur = fused
            recovered = True
        self.state = State.OK

        # velocity model host mirror (the device carry tracks its own copy;
        # this one seeds carry rewrites on the rare host-pose paths)
        Rl_inv = self._last_R.T
        self._vel = (np.asarray(R_cur @ Rl_inv, np.float32),
                     np.asarray(t_cur - (R_cur @ Rl_inv) @ self._last_t,
                                np.float32))
        # NOTE: no single-frame-failure eviction. Evicting points that
        # disagree with the current pose estimate self-selects the cache for
        # drift-compatible points and collapses the correction gain of the
        # tracker (measured: the divergence gain of the whole loop flips
        # above 1). Bad points are removed by found-ratio culling at KFs
        # (the reference evicts more eagerly but re-searches the FULL local
        # map every frame, src/Tracking.cc:2271-2330, which restores lost
        # points — our cache rebuild at KFs plays that role).

        # ---- keyframe decision -------------------------------------------
        need_kf = self._need_new_keyframe(ts, n_inliers, t_ids, R_cur, t_cur)
        if need_kf:
            pyr = pyr_fn()
            with self.timer.stage("keyframe"):
                R_ba, t_ba = self._create_keyframe(pyr, ts, R_cur, t_cur,
                                                   t_ids, t_uv, t_lvl)
            # adopt the BA-corrected pose for this frame
            R_cur, t_cur = R_ba, t_ba
            recovered = True

        if recovered and (not batch_mode or aborted):
            # host changed the pose (fallback / fusion / KF-BA) or the cache
            # snapshot was swapped: rebuild the device carry from host state.
            # Clean in-batch keyframes skip this: the later batch frames
            # already tracked past this one, so corrections flow through the
            # map (async-LocalMapping semantics) instead of the carry.
            self._set_last_frame(pyr_fn(), R_cur, t_cur,
                                 cache_uv=(t_ids, t_uv))
        elif batch_mode and recovered:
            # clean in-batch keyframe: the device carry keeps the
            # UNcorrected chain, so the host pose mirror must too — mixing
            # the BA-corrected pose into _last_R/_last_t would poison the
            # next frame's velocity mirror (ADVICE r3). The corrected pose
            # still flows to the caller/trajectory via the return value.
            self._last_R = np.asarray(out.R, np.float32)
            self._last_t = np.asarray(out.t, np.float32)
        else:
            # common case: the carry already advanced on device; only the
            # cheap host mirrors need updating
            self._last_R = np.asarray(R_cur, np.float32)
            self._last_t = np.asarray(t_cur, np.float32)
        return True, R_cur, t_cur, not aborted

    def _tail_idle(self) -> bool:
        """True when no mapping-tail work is queued or in flight."""
        return (self._map_worker is None
                or self._map_queue.unfinished_tasks == 0)

    def _need_new_keyframe(self, ts, n_inliers, t_ids, R_cur, t_cur) -> bool:
        """Keyframe decision (reference NeedNewKeyFrame,
        src/Tracking.cc:1402-1525): c1a = long gap; c1b = min gap AND mapper
        idle; c1c = weak tracking or close-point starvation (stereo/RGB-D);
        c2 = tracked fraction below kf_ratio of the reference KF. The IMU
        cTimeGap (>0.5 s) is added by the mono-VI subclass."""
        cfg = self.cfg
        if self.localization_only:
            return False
        gap = self.frame_id - self._last_kf_frame
        if gap < cfg.kf_min_gap:
            return False
        if gap >= cfg.kf_max_gap:               # c1a: hard cap
            return True
        mapper_idle = self._tail_idle()
        if self._kf_time_gap(ts) and mapper_idle:   # cTimeGap (VIO)
            return True
        c1b = mapper_idle
        c1c = (n_inliers < 50
               or self._need_close_points(t_ids, R_cur, t_cur))
        c2 = (n_inliers < cfg.kf_ratio * self._kf_ref_tracked
              or n_inliers < 50)
        if not (c1b or c1c) or not c2:
            return False
        # queue-limit: when the mapper is busy, only truly weak tracking
        # justifies blocking on a new KF (reference keeps the queue <3 and
        # interrupts BA, src/Tracking.cc:1516-1523; our tail is one job deep)
        if not mapper_idle and n_inliers >= 50:
            return False
        return True

    def _need_close_points(self, t_ids, R_cur, t_cur,
                           min_close: int = 100,
                           min_candidates: int = 70) -> bool:
        """Stereo/RGB-D c1c term (reference src/Tracking.cc:1445-1460):
        tracked close points (z < ThDepth) scarce AND enough close-depth
        candidates exist that a new KF would actually seed some. The
        reference counts untracked FEATURES with depth < ThDepth; on the
        direct path no features exist per frame, so the candidate count is
        estimated from the depth source itself (see _close_candidates)."""
        if not self._depth_source_available() or len(t_ids) == 0:
            return False
        Xc = self.map.pt_xyz[t_ids] @ np.asarray(R_cur).T + np.asarray(t_cur)
        if int((Xc[:, 2] < self._th_depth()).sum()) >= min_close:
            return False
        return self._close_candidates() >= min_candidates

    def _close_candidates(self) -> int:
        """Estimated count of feature-rate close-depth candidates in the
        current frame. RGB-D: coarse-grid sample of the depth map scaled to
        the feature budget. Stereo (no depth map): assume candidates exist
        (the KF's disparity search decides)."""
        depth = getattr(self, "_cur_depth", None)
        if depth is None or not hasattr(depth, "shape"):
            return 1 << 30
        d = np.asarray(depth)[::16, ::16]
        frac = float(((d > 0.1) & (d < self._th_depth())).mean())
        return int(frac * self.cfg.n_features)

    def _kf_time_gap(self, ts) -> bool:
        """IMU cTimeGap hook (reference: >0.5 s since last KF under VIO)."""
        return False

    def _set_last_frame(self, pyr, R, t, cache_uv):
        smap = self.map
        cap = self.cfg.max_track
        self._last_pyr = pyr
        self._last_R = np.array(R, np.float32)
        self._last_t = np.array(t, np.float32)
        uv = np.zeros((cap, 2), np.float32)
        Xc = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        if cache_uv is None:
            # fresh after init: project current map points
            ids = self._cache
            X = smap.pt_xyz[ids]
            Xc_all = X @ self._last_R.T + self._last_t
            uvp = np.stack([
                self.cam.fx * Xc_all[:, 0] / Xc_all[:, 2] + self.cam.cx,
                self.cam.fy * Xc_all[:, 1] / Xc_all[:, 2] + self.cam.cy], -1)
            m = min(len(ids), cap)
            uv[:m] = uvp[:m]
            Xc[:m] = Xc_all[:m]
            valid[:m] = Xc_all[:m, 2] > 0.1
        else:
            ids, uvs = cache_uv
            m = min(len(ids), cap)
            uv[:m] = uvs[:m]
            X = smap.pt_xyz[ids[:m]]
            Xc[:m] = X @ self._last_R.T + self._last_t
            valid[:m] = Xc[:m, 2] > 0.1
        self._last_uv = uv
        self._last_Xc = Xc
        self._last_valid = valid
        # device carry rebuild (rare host-pose path; the steady state
        # advances the carry inside frame_step without host involvement)
        self._carry = make_carry(pyr, self._last_R, self._last_t,
                                 uv, Xc, valid,
                                 Rv=self._vel[0], tv=self._vel[1])

    def _rebuild_cache(self):
        """Refill the direct cache with local-map points (reference
        SearchLocalPointsDirect cache widening, src/Tracking.cc:2334-2406)
        and upload the per-point tracking state to the device once — the
        per-frame direct tracker then reads it in place."""
        smap = self.map
        if smap.n_kf == 0:
            return
        ref_kf = self._last_kf if self._last_kf >= 0 else smap.n_kf - 1
        win = smap.local_window(ref_kf, 10)
        pts = smap.points_in_kfs(win)
        if len(pts) > self.cfg.max_track:
            order = np.argsort(-smap.pt_obs[pts])
            pts = pts[order[: self.cfg.max_track]]
        self._cache = pts
        self._upload_cache()

    def _upload_cache(self):
        """Snapshot the cached points' device-side tracking state (xyz,
        stored ref patches, capture geometry). Called under the map lock."""
        smap = self.map
        ids = self._cache
        cap = self.cfg.max_track
        n = len(ids)
        pad = cap - n

        def g(a):
            if pad > 0:
                return np.concatenate(
                    [a[ids], np.zeros((pad,) + a.shape[1:], a.dtype)])
            return a[ids][:cap]

        pvalid = g(smap.pt_valid)
        xyz = g(smap.pt_xyz)
        # ONE packed buffer (framestep.CACHE_COLS layout), uploaded as 4
        # pool slices (it runs once per keyframe)
        packed = pack_cache_np(
            xyz, pvalid, g(smap.pt_patch), g(smap.pt_ref_uv),
            g(smap.pt_ref_level), g(smap.pt_ref_R), g(smap.pt_ref_t))
        futs = [self._upload_pool.submit(_device_put_block, p)
                for p in np.array_split(packed, 4)]
        self._cache_dev = _concat_chunks(*[f.result() for f in futs])
        # host copy of the snapshot's point positions: consumers that need
        # world coordinates for the TRACKED points (the VI filter's
        # reprojection factors) read THIS, not the live map — the async
        # worker rewrites smap.pt_xyz under its own lock, and an unlocked
        # mid-commit read would hand the filter a half-updated world that
        # the marginal prior then propagates forward (r4 async-VI fix)
        self._cache_xyz_host = xyz
        self._publish_snapshot()

    def _publish_snapshot(self):
        """Atomically publish the tracking snapshot (cache ids + device
        cache + ref-KF pose). Called under the map lock; the tracking hot
        path reads self._snap without locking."""
        smap = self.map
        ref = self._last_kf
        if ref >= 0 and ref < smap.n_kf:
            Rk, tk = smap.kf_R[ref].copy(), smap.kf_t[ref].copy()
        else:
            ref, Rk, tk = -1, np.eye(3, dtype=np.float32), \
                np.zeros(3, np.float32)
        self._snap = (self._cache, self._cache_dev, ref, Rk, tk,
                      getattr(self, "_cache_xyz_host", None))

    def warm_failure_paths(self):
        """Trace + compile (or persistent-cache-load) every FAILURE-path
        device program — the feature-fallback ladder and relocalization —
        without disturbing tracking state. The clean startup warmup never
        exercises these paths, so their first invocation used to land
        mid-run and compile there (r4/r5 bench: `big_compiles` on otherwise
        compile-clean runs). The
        reference "loads vocabulary" at startup; we "compile kernels"
        (SURVEY §7.3) — ALL of them. Call after initialization."""
        if self.state != State.OK or self.map.n_kf == 0 \
                or self._carry is None:
            return
        pyr = self._carry.pyr
        f = self._feats_to_dict(self.extractor(pyr))
        with self._map_lock:
            ids = self._cache.copy()
        R, t = self._last_R, self._last_t
        # every (radius, ratio) combination the ladder/reloc paths bake
        # into their match programs (python floats become trace constants:
        # each distinct value is a separate executable)
        pt_ids = slots = None
        for radius, ratio in ((15.0, 0.9), (30.0, 0.9), (8.0, 0.8),
                              (10.0, 0.85), (20.0, 0.85)):
            got = self._match_points_to_feats(ids, R, t, f, radius=radius,
                                              ratio=ratio)
            if pt_ids is None or len(got[0]) > len(pt_ids):
                pt_ids, slots = got
        if len(pt_ids):
            self._pose_opt_matches(pt_ids, slots, f, R, t)
        # ref-KF BoW-gated match program (result discarded)
        self._track_reference_keyframe(f)
        # relocalization programs: node-gated match + PnP RANSAC
        if self.bow_index is not None:
            smap = self.map
            kf = self._last_kf
            if kf >= 0 and not smap.kf_feat_pending[kf]:
                self._frame_groups(f)
                gk = (jnp.asarray(self.bow_index.feat_groups(kf))
                      if (kf < len(self.bow_index.kf_valid)
                          and self.bow_index.kf_valid[kf]) else None)
                matching.match_with_windows(
                    jnp.asarray(f["desc"]), jnp.asarray(f["valid"]),
                    jnp.asarray(smap.kf_feat_desc[kf]),
                    jnp.asarray(smap.kf_feat_pt[kf] >= 0),
                    max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
                    ang1=jnp.asarray(f["angle"]),
                    ang2=jnp.asarray(smap.kf_feat_angle[kf]),
                    groups1=jnp.asarray(f["groups"]), groups2=gk)
            cap = 512
            n = min(len(ids), cap)
            X = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            valid = np.zeros(cap, bool)
            if n:
                X[:n] = smap.pt_xyz[ids[:n]]
                Xc = X[:n] @ R.T + t
                z = np.maximum(Xc[:, 2], 1e-3)
                uv[:n] = np.stack([self.cam.fx * Xc[:, 0] / z + self.cam.cx,
                                   self.cam.fy * Xc[:, 1] / z + self.cam.cy],
                                  -1)
                valid[:n] = True
            self._rng, key = jax.random.split(self._rng)
            pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                       self.intr, key, min_inliers=15)

    # ------------------------------------------------ feature-method fallbacks
    def _match_points_to_feats(self, pt_ids, R, t, f, radius, ratio=0.9,
                               max_dist=matching.TH_HIGH, cap=1024):
        """Project map points with pose (R,t) and window-match their
        distinctive descriptors against the frame's extracted features — the
        batched form of ORBmatcher::SearchByProjection (the reference's
        per-point grid walk, src/ORBmatcher.cc decl include/ORBmatcher.h:66).
        Returns (matched point ids, matched feature slots)."""
        smap = self.map
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if len(pt_ids) == 0:
            return empty
        Xc = smap.pt_xyz[pt_ids] @ R.T + t
        z = Xc[:, 2]
        uvp = np.stack([self.cam.fx * Xc[:, 0] / np.maximum(z, 1e-6)
                        + self.cam.cx,
                        self.cam.fy * Xc[:, 1] / np.maximum(z, 1e-6)
                        + self.cam.cy], -1).astype(np.float32)
        inb = ((z > 0.1) & (uvp[:, 0] > 10) & (uvp[:, 0] < self.cam.width - 10)
               & (uvp[:, 1] > 10) & (uvp[:, 1] < self.cam.height - 10))
        pt_ids = np.asarray(pt_ids)[inb]
        uvp = uvp[inb]
        if len(pt_ids) == 0:
            return empty
        n = min(len(pt_ids), cap)
        descA = np.zeros((cap, 256), np.uint8)
        uvA = np.zeros((cap, 2), np.float32)
        vA = np.zeros(cap, bool)
        descA[:n] = smap.pt_desc[pt_ids[:n]]
        uvA[:n] = uvp[:n]
        vA[:n] = True
        idx, ok = matching.match_with_windows(
            jnp.asarray(descA), jnp.asarray(vA),
            jnp.asarray(f["desc"]), jnp.asarray(f["valid"]),
            uv_pred1=jnp.asarray(uvA), uv2=jnp.asarray(f["uv"]),
            radius=radius, max_dist=max_dist, ratio=ratio, mutual=True)
        idx = np.asarray(idx)[:n]
        rows = np.nonzero(np.asarray(ok)[:n])[0]
        return pt_ids[:n][rows], idx[rows].astype(np.int64)

    def _pose_opt_matches(self, pt_ids, slots, f, R0, t0):
        """Pose-only GN over point->feature matches. Returns (result,
        per-match inlier mask, n actually used)."""
        cap = self.cfg.max_track
        n = min(len(pt_ids), cap)
        X = np.zeros((cap, 3), np.float32)
        uv = np.zeros((cap, 2), np.float32)
        is2 = np.ones(cap, np.float32)
        val = np.zeros(cap, bool)
        X[:n] = self.map.pt_xyz[pt_ids[:n]]
        uv[:n] = f["uv"][slots[:n]]
        is2[:n] = 0.25 ** f["level"][slots[:n]]
        val[:n] = True
        res = pose_optimization(
            jnp.asarray(X), jnp.asarray(uv), jnp.asarray(is2),
            jnp.asarray(val), jnp.asarray(np.asarray(R0, np.float32)),
            jnp.asarray(np.asarray(t0, np.float32)), self.intr)
        return res, np.asarray(res.inliers)[:n], n

    def _feature_fallback(self, pyr, R_pred, t_pred):
        """Reference escalation ladder on direct-tracking failure
        (src/Tracking.cc:473-476, 563-577): extract features once, then
        motion model -> reference keyframe -> feature local-map tracking.
        Returns (R, t, pt_ids, uv, lvl) or None (-> LOST)."""
        if self.map.n_kf == 0:
            return None
        f = self._feats_to_dict(self.extractor(pyr))
        pose = self._track_with_motion_model(f, R_pred, t_pred)
        self.debug["fb_motion"] = pose is not None
        if pose is None:
            pose = self._track_reference_keyframe(f)
            self.debug["fb_refkf"] = pose is not None
        if pose is None:
            return None
        out = self._track_local_map_features(f, *pose)
        self.debug["fb_localmap"] = out is not None
        return out

    def _track_with_motion_model(self, f, R_pred, t_pred,
                                 min_matches: int = 20,
                                 min_inliers: int = 10):
        """Project the last frame's tracked points with the predicted pose
        and descriptor-match in a window; x2-radius retry as the reference
        does (Tracking::TrackWithMotionModel src/Tracking.cc:1152-1211)."""
        with self._map_lock:
            ids = self._cache.copy()
        best_n, best_res = 0, None
        for radius in (15.0, 30.0):
            pt_ids, slots = self._match_points_to_feats(
                ids, R_pred, t_pred, f, radius=radius, ratio=0.9)
            if len(pt_ids) < min_matches:
                continue
            res, _, _ = self._pose_opt_matches(pt_ids, slots, f,
                                               R_pred, t_pred)
            n_inl = int(np.asarray(res.n_inliers))
            if n_inl > best_n:
                best_n, best_res = n_inl, res
            # Widen the window not only when matches are SCARCE (the
            # reference's retry trigger) but also when the pose-opt
            # consensus is WEAK: with a badly-off prediction the narrow
            # window contains only spurious corners, which can still form
            # >=min_matches mutual descriptor matches whose GN consensus is
            # junk. A healthy window has a large inlier fraction.
            if n_inl >= min_inliers and n_inl >= 0.6 * len(pt_ids):
                return self._pose_np(res.R, res.t)
        if best_res is None or best_n < min_inliers:
            return None
        return self._pose_np(best_res.R, best_res.t)

    def _frame_groups(self, f):
        """Quantize a frame's descriptors and return their FeatureVector
        group ids (cached in f["groups"]) — the frame side of node-gated
        SearchByBoW (reference Frame::ComputeBoW src/Frame.cc:495-507)."""
        if self.bow_index is None:
            return None
        if "groups" not in f:
            wid, _ = self.bow_index.quantize(f["desc"], f["valid"])
            f["wid"] = wid
            f["groups"] = self.bow_index.groups_of(wid)
        return f["groups"]

    def _track_reference_keyframe(self, f, min_matches: int = 15,
                                  min_inliers: int = 10):
        """Node-gated BoW match against the reference KF's bound features +
        pose opt from the last pose (Tracking::TrackReferenceKeyFrame
        src/Tracking.cc:1008-1063 via ORBmatcher::SearchByBoW
        src/ORBmatcher.cc:155-263: candidates restricted to the same
        vocabulary-tree node, batched here as a group-gated mutual NN with
        the reference's 0.7 ratio)."""
        kf = self._last_kf
        smap = self.map
        # the newest KF's descriptors may still be placeholder zeros while
        # the async worker runs its deferred extraction — fall back to the
        # newest READY keyframe instead of matching against garbage
        # (ADVICE r4)
        while kf >= 0 and (not smap.kf_valid[kf]
                           or smap.kf_feat_pending[kf]):
            kf -= 1
        if kf < 0:
            return None
        g1 = g2 = None
        if (self.bow_index is not None
                and kf < len(self.bow_index.kf_valid)
                and self.bow_index.kf_valid[kf]):
            fg = self._frame_groups(f)
            if fg is not None:
                g1 = jnp.asarray(self.bow_index.feat_groups(kf))
                g2 = jnp.asarray(fg)
        with self._map_lock:
            bound = smap.kf_feat_pt[kf] >= 0
            if int(bound.sum()) < min_matches:
                return None
            fK = self.mapper.kf_dev_feats(smap, kf)  # device mirror
            idx, ok = matching.match_with_windows(
                fK["desc"], jnp.asarray(bound),
                jnp.asarray(f["desc"]), jnp.asarray(f["valid"]),
                max_dist=matching.TH_LOW, ratio=0.7,
                ang1=fK["angle"],
                ang2=jnp.asarray(f["angle"]), mutual=True,
                groups1=g1, groups2=g2)
            idx = np.asarray(idx)
            rows = np.nonzero(np.asarray(ok))[0]
            if len(rows) < min_matches:
                return None
            pt_ids = smap.kf_feat_pt[kf, rows]
            slots = idx[rows]
            good = smap.pt_valid[pt_ids]
            pt_ids, slots = pt_ids[good], slots[good]
        if len(pt_ids) < min_matches:
            return None
        res, inl, _ = self._pose_opt_matches(pt_ids, slots, f,
                                             self._last_R, self._last_t)
        if int(np.asarray(res.n_inliers)) < min_inliers:
            return None
        return self._pose_np(res.R, res.t)

    def _track_local_map_features(self, f, R, t):
        """Feature-method TrackLocalMap (reference src/Tracking.cc:1213-1262
        via SearchLocalPoints :1628): project the local map with the
        recovered pose, window-match, final pose opt; succeed at
        min_track_inliers. Returns (R, t, pt_ids, uv, lvl) or None."""
        with self._map_lock:
            self._rebuild_cache()
            ids = self._cache.copy()
        pt_ids, slots = self._match_points_to_feats(
            ids, R, t, f, radius=8.0, ratio=0.8)
        if len(pt_ids) < self.cfg.min_track_inliers:
            return None
        res, inl, n = self._pose_opt_matches(pt_ids, slots, f, R, t)
        if int(np.asarray(res.n_inliers)) < self.cfg.min_track_inliers:
            return None
        rows = np.nonzero(inl)[0]
        R_cur, t_cur = self._pose_np(res.R, res.t)
        return (R_cur, t_cur, pt_ids[:n][rows],
                f["uv"][slots[:n][rows]].astype(np.float32),
                f["level"][slots[:n][rows]].astype(np.int32))

    # -------------------------------------------------------------- keyframes
    def _extract_kf_features(self, pyr, uv_pad, lvl_pad, val_pad):
        """Descriptors/angles at the tracked positions (deferred extraction
        — the core of the reference's 3x speedup, include/Frame.h:298) plus
        fresh grid/octree features in the unoccupied image area — ONE fused
        device program (extractor.extract_keyframe; the round-4 path
        dispatched describe_at + per-level occupancy stamps + the extractor
        separately, ~6 launches per keyframe)."""
        ang, desc, new_feats = self.extractor.extract_keyframe(
            pyr, uv_pad, lvl_pad, val_pad)
        self.timer.dispatches["keyframe_extract"] += 1
        ang = np.asarray(ang)
        desc = np.asarray(desc)
        nf = jax.tree.map(np.asarray, new_feats)

        feats = {
            "uv": np.concatenate([uv_pad, nf.uv]),
            "level": np.concatenate([lvl_pad, nf.level]),
            "angle": np.concatenate([ang, nf.angle]),
            "desc": np.concatenate([desc, nf.desc]),
            "valid": np.concatenate([val_pad, nf.valid]),
        }
        feats["ur"] = self._feature_ur(feats, pyr)
        return feats

    def _extract_into_kf(self, kf, pyr, uv_pad, lvl_pad, val_pad):
        """Tail half of deferred keyframe extraction: compute the full
        feature set and write it into the (already-added) keyframe's rows.
        Runs on the mapping worker BEFORE the keyframe's mapping tail, so
        triangulation/fusion/BoW always see complete descriptors."""
        feats = self._extract_kf_features(pyr, uv_pad, lvl_pad, val_pad)
        smap = self.map
        with self._map_lock:
            if kf >= smap.n_kf:   # reset swapped the map after queueing
                return
            mm = min(len(feats["uv"]), smap.max_feat)
            smap.kf_feat_uv[kf, :mm] = feats["uv"][:mm]
            smap.kf_feat_level[kf, :mm] = feats["level"][:mm]
            smap.kf_feat_desc[kf, :mm] = feats["desc"][:mm]
            smap.kf_feat_angle[kf, :mm] = feats["angle"][:mm]
            smap.kf_feat_valid[kf, :mm] = feats["valid"][:mm]
            smap.kf_feat_ur[kf, :mm] = feats["ur"][:mm]
            smap.kf_feat_pending[kf] = False
            smap.kf_feat_version[kf] += 1

    def _create_keyframe(self, pyr, ts, R, t, tracked_ids, tracked_uv,
                         tracked_lvl):
        smap = self.map
        cfg = self.cfg
        cap = cfg.max_track
        m = min(len(tracked_ids), cap)

        uv_pad = np.zeros((cap, 2), np.float32)
        lvl_pad = np.zeros(cap, np.int32)
        val_pad = np.zeros(cap, bool)
        uv_pad[:m] = tracked_uv[:m]
        lvl_pad[:m] = tracked_lvl[:m]
        val_pad[:m] = True

        # off-thread extraction (VERDICT r3 #3): with the async worker the
        # tracking thread only records the KF skeleton (pose + tracked
        # binds); descriptors + fresh features land in the worker BEFORE the
        # KF's mapping tail. Depth-seeded modes keep inline extraction (the
        # per-frame depth map feeds _create_depth_points immediately).
        defer = (cfg.async_mapping and self._map_worker is not None
                 and not self._depth_source_available()
                 and not self.localization_only)
        if defer:
            feats = {
                "uv": uv_pad, "level": lvl_pad, "valid": val_pad,
                "angle": np.zeros(cap, np.float32),
                "desc": np.zeros((cap, 256), np.uint8),
                "ur": np.full(cap, -1.0, np.float32),
            }
        else:
            feats = self._extract_kf_features(pyr, uv_pad, lvl_pad, val_pad)
        with self._map_lock:
            kf = smap.add_keyframe(R, t, feats, ts=ts,
                                   frame_id=self.frame_id, pyramid=pyr)
            if defer:
                # descriptor rows are placeholders until _extract_into_kf
                # runs on the worker; matching against them silently fails
                # (ADVICE r4) — consumers skip pending KFs
                smap.kf_feat_pending[kf] = True
            smap.bind(kf, np.arange(m), tracked_ids[:m])
            # depth-seeded map points (RGB-D / stereo-depth path; reference
            # CreateNewKeyFrame close-point insertion src/Tracking.cc:1556-1608)
            if self._depth_source_available():
                self._create_depth_points(smap, kf, pyr)
            self._last_kf = kf
            self._last_kf_frame = self.frame_id
            self._kf_ref_tracked = int((smap.kf_feat_pt[kf] >= 0).sum())
            # re-publish the tracking snapshot against the new reference KF
            self._publish_snapshot()
        # pre-enqueue hook: the mono-VI tracker records the KF's IMU window
        # here so an async mapping worker sees a complete chain
        self._on_keyframe_created(kf, ts)

        if self.cfg.async_mapping and self._map_worker is not None:
            def tail_job():
                if defer:
                    self._extract_into_kf(kf, pyr, uv_pad, lvl_pad, val_pad)
                self._mapping_tail(kf, pyr)
            self._map_queue.put(tail_job)
            # tracking keeps the pre-BA pose; corrections land via the map
            return smap.kf_R[kf].copy(), smap.kf_t[kf].copy()
        self._mapping_tail(kf, pyr)
        # report the post-BA pose of this keyframe to the caller
        return smap.kf_R[kf].copy(), smap.kf_t[kf].copy()

    def stats(self) -> dict:
        """Structured counters for observability (SURVEY §5: the reference
        has only glog prints + the Pangolin window)."""
        smap = self.map
        return {
            "state": self.state.name,
            "frame_id": self.frame_id,
            "n_kf": int(smap.kf_valid[: smap.n_kf].sum()),
            "n_pt": int(smap.pt_valid[: smap.n_pt].sum()),
            "n_loops_closed": self.n_loops_closed,
            "cache_size": len(self._cache),
            "stage_ms": self.timer.mean_ms(),
            # device-program launches per stage (VERDICT r4 weak #6)
            "dispatches": dict(self.timer.dispatches),
            # capacity-drop counters (no-silent-caps rule, SURVEY §7.3):
            # nonzero values mean BA problems exceeded their buckets and
            # shed support-ranked landmarks/observations
            "ba_dropped": dict(self.mapper.dropped),
        }

    def _mapping_tail(self, kf, pyr):
        """The LocalMapping duties for one keyframe (triangulate, fuse, BA,
        cull, place recognition, loop closing). Runs synchronously or on the
        mapping worker thread; map mutations hold the map lock."""
        smap = self.map
        with self.timer.stage("mapping_tail"), self._map_lock:
            # a reset may have swapped self.map after this job was queued:
            # the KF id then points into a different (fresh) map — drop it
            if kf >= smap.n_kf or not smap.kf_valid[kf]:
                return
            # triangulate new points against recent covisible keyframes
            with self.timer.stage("mt_triangulate"):
                cov = smap.covisibility(kf)
                # skip partners whose deferred descriptor extraction has not
                # run yet (their rows are placeholder zeros, ADVICE r4)
                cov = np.where(smap.kf_feat_pending[: len(cov)], 0, cov)
                order = np.argsort(-cov)[:3]
                partners = [int(p) for p in order
                            if cov[p] > 0
                            or (p == self._last_kf
                                and not smap.kf_feat_pending[p])]
                # all partners in ONE fused device program (VERDICT r5 #2;
                # the sequential path cost ~4 dispatches per partner)
                self.mapper.create_points_multi(smap, kf, partners, pyr)
            # grow observations + fuse duplicates across the neighborhood
            # (two-hop SearchInNeighbors, both directions)
            with self.timer.stage("mt_fuse"):
                self.mapper.search_in_neighbors(smap, kf)
                smap.assign_parent(kf)
                self.mapper.update_distinctive_descriptors(smap, kf)
            with self.timer.stage("mt_local_ba"):
                self._run_local_ba(smap, kf)
            with self.timer.stage("mt_cull"):
                self.mapper.cull_points(smap)
                n_culled = self._cull_keyframes(smap, kf)
            if n_culled and self.bow_index is not None:
                m = min(len(self.bow_index.kf_valid), smap.n_kf)
                self.bow_index.kf_valid[:m] &= smap.kf_valid[:m]

            # refresh direct patches for ALL points bound to this KF with
            # the POST-BA geometry — stale capture geometry after BA was the
            # main divergence mode of the first implementation
            with self.timer.stage("mt_patches"):
                slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
                ids = smap.kf_feat_pt[kf, slots]
                self.mapper.refresh_patches(smap, kf, pyr, ids, slots)

            # place recognition: index this KF, attempt loop closure
            if self.bow_index is not None:
                wid, bow = self.bow_index.quantize(smap.kf_feat_desc[kf],
                                                   smap.kf_feat_valid[kf])
                self.bow_index.add_keyframe(kf, bow, feat_wid=wid)
                if (self.cfg.enable_loop_closing
                        and self.loop_closer is not None):
                    if self.loop_closer.process_keyframe(smap, kf, bow):
                        self.n_loops_closed += 1
                        # global BA after loop correction (the reference
                        # spawns RunGlobalBundleAdjustment,
                        # src/LoopClosing.cc:538)
                        self.mapper.global_ba(smap)
                        slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
                        self.mapper.refresh_patches(
                            smap, kf, pyr, smap.kf_feat_pt[kf, slots], slots)
                        self._vel = (np.eye(3, dtype=np.float32),
                                     np.zeros(3, np.float32))

            self._rebuild_cache()

    def _run_local_ba(self, smap, kf):
        """Local BA dispatch; the mono-VI tracker swaps in the NavState
        window BA once VINS-initialized."""
        self.mapper.local_ba(smap, kf)

    def _cull_keyframes(self, smap, kf):
        """Keyframe-culling dispatch; the mono-VI tracker adds the IMU-chain
        guards and merges culled KFs' IMU windows into their successors."""
        return self.mapper.cull_keyframes(smap, kf)

    def _on_keyframe_created(self, kf, ts):
        """Called after a keyframe is added, before its mapping tail is
        dispatched (possibly to the async worker)."""

    # ------------------------------------------------------------ vio hooks
    def _predict_pose(self):
        """Optional pose prediction override (mono-VI: IMU propagation).
        Return (R_pred, t_pred) or None to use the velocity model."""
        return None

    def _fuse_pose(self, R_cur, t_cur, ids, uv, lvl, xyz=None):
        """Optional sensor-fusion refinement of the visually tracked pose.
        `xyz`: snapshot-consistent world positions for `ids` (None = read
        the live map under the lock). Return (R, t) or None to keep the
        visual pose."""
        return None

    def _on_vision_failed(self, pyr, ts, R_pred, t_pred) -> bool:
        """Called when direct tracking fails. Return True to keep tracking
        with the predicted pose (IMU dead-reckoning); False -> LOST."""
        return False

    # ------------------------------------------------------------ depth seeds
    def _feature_ur(self, f, pyr):
        """Per-feature right-image u coordinate u_r (the reference's
        mvuRight, src/Frame.cc:509-701); -1 = monocular. Overridden by the
        RGB-D (depth lookup) and stereo (disparity search) trackers; these
        feed the 3-D (u,v,u_r) BA edges."""
        return np.full(len(f["uv"]), -1.0, np.float32)

    def _depth_source_available(self) -> bool:
        return getattr(self, "_cur_depth", None) is not None

    def _feature_depths(self, smap, kf, slots):
        """Per-slot metric depths for depth-seeded point creation.
        RGB-D: direct lookup in the frame's depth map. Overridden by the
        stereo tracker (disparity search)."""
        depth = self._cur_depth
        uv = smap.kf_feat_uv[kf, slots]
        xi = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
        yi = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
        return np.asarray(depth)[yi, xi]

    def _th_depth(self) -> float:
        """Metric close/far threshold: bf/fx * ThDepth (reference
        src/Tracking.cc:252-258); a wide absolute default when bf unset."""
        if self.cam.bf > 0:
            return self.cam.bf / self.cam.fx * self.cfg.th_depth
        return 40.0

    def _create_depth_points(self, smap, kf, pyr, min_points: int = 100):
        """Create map points for unbound features with valid depth.
        Close points (z < ThDepth) are always inserted; far ones only
        nearest-first until `min_points` total (reference CreateNewKeyFrame
        close/far policy, src/Tracking.cc:1556-1608)."""
        unbound = smap.kf_feat_valid[kf] & (smap.kf_feat_pt[kf] < 0)
        slots = np.nonzero(unbound)[0]
        if len(slots) == 0:
            return 0
        d = self._feature_depths(smap, kf, slots)
        uv = smap.kf_feat_uv[kf, slots]
        ok = (d > 0.1) & np.isfinite(d)
        ok &= np.asarray(self.mapper.patch_in_bounds(
            uv, smap.kf_feat_level[kf, slots]))
        slots, uv, d = slots[ok], uv[ok], d[ok]
        if len(slots) == 0:
            return 0
        order = np.argsort(d)                   # nearest first
        th = self._th_depth()
        keep = (d[order] < th) | (np.arange(len(order)) < min_points)
        sel = order[keep]
        slots, uv, d = slots[sel], uv[sel], d[sel]
        xn = np.stack([(uv[:, 0] - self.cam.cx) / self.cam.fx,
                       (uv[:, 1] - self.cam.cy) / self.cam.fy], -1)
        Xc = np.concatenate([xn * d[:, None], d[:, None]], -1)
        R = smap.kf_R[kf]
        t = smap.kf_t[kf]
        Xw = (Xc - t) @ R  # R^T (Xc - t)
        ids = smap.alloc_points(len(slots))
        smap.pt_xyz[ids] = Xw.astype(np.float32)
        smap.pt_valid[ids] = True
        smap.pt_first_kf[ids] = kf
        smap.pt_desc[ids] = smap.kf_feat_desc[kf, slots]
        smap.bind(kf, slots, ids)
        self.mapper.refresh_patches(smap, kf, pyr, ids, slots)
        return len(slots)

    # ---------------------------------------------------------- relocalization
    def _relocalize(self, pyr) -> bool:
        """BoW candidates + robust PnP (reference Tracking::Relocalization
        src/Tracking.cc:1826-1978, via our batched linear-PnP RANSAC)."""
        if self.bow_index is None:
            return False
        smap = self.map
        feats = self.extractor(pyr)
        f = self._feats_to_dict(feats)
        wid, bow = self.bow_index.quantize(f["desc"], f["valid"])
        f["wid"] = wid
        f["groups"] = self.bow_index.groups_of(wid)
        cands = self.bow_index.reloc_candidates(bow, max_candidates=5)
        for kf in cands:
            bound = smap.kf_feat_pt[kf] >= 0
            if bound.sum() < 15:
                continue
            # node-gated SearchByBoW (reference Relocalization matches via
            # SearchByBoW, src/Tracking.cc:1847)
            gk = (jnp.asarray(self.bow_index.feat_groups(kf))
                  if self.bow_index.kf_valid[kf] else None)
            fK = self.mapper.kf_dev_feats(smap, kf)  # device mirror
            idx, ok = matching.match_with_windows(
                jnp.asarray(f["desc"]), jnp.asarray(f["valid"]),
                fK["desc"], jnp.asarray(bound),
                max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
                ang1=jnp.asarray(f["angle"]),
                ang2=fK["angle"],
                groups1=jnp.asarray(f["groups"]), groups2=gk)
            idx = np.asarray(idx)
            okm = np.asarray(ok)
            rows = np.nonzero(okm)[0]
            if len(rows) < 10:
                continue
            pt_ids = smap.kf_feat_pt[kf, idx[rows]]
            good = smap.pt_valid[pt_ids]
            rows, pt_ids = rows[good], pt_ids[good]
            if len(rows) < 10:
                continue
            cap = 512
            n = min(len(rows), cap)
            X = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            valid = np.zeros(cap, bool)
            X[:n] = smap.pt_xyz[pt_ids[:n]]
            uv[:n] = f["uv"][rows[:n]]
            valid[:n] = smap.pt_valid[pt_ids[:n]]
            self._rng, key = jax.random.split(self._rng)
            res = pnp_ransac(jnp.asarray(X), jnp.asarray(uv),
                             jnp.asarray(valid), self.intr, key,
                             min_inliers=15)
            if not bool(res.ok):
                continue
            R = np.asarray(res.R)
            t = np.asarray(res.t)
            # escalation (reference src/Tracking.cc:1933-1978): verify the
            # PnP pose with a pose-only GN on the BoW matches, then widen by
            # projection search over the candidate's local map until >=50
            # inliers; raw PnP acceptance was the round-1 shortcut.
            opt, _, _ = self._pose_opt_matches(pt_ids[:n], rows[:n], f, R, t)
            if int(np.asarray(opt.n_inliers)) < 10:
                continue
            R, t = self._pose_np(opt.R, opt.t)
            n_inl = int(np.asarray(opt.n_inliers))
            for radius in (10.0, 20.0):
                if n_inl >= 50:
                    break
                local_pts = smap.points_in_kfs(smap.local_window(kf, 10))
                m_ids, m_slots = self._match_points_to_feats(
                    local_pts, R, t, f, radius=radius, ratio=0.85)
                if len(m_ids) < 20:
                    continue
                opt, _, _ = self._pose_opt_matches(m_ids, m_slots, f, R, t)
                n_inl = int(np.asarray(opt.n_inliers))
                R, t = self._pose_np(opt.R, opt.t)
            if n_inl < 50:
                continue
            self._vel = (np.eye(3, dtype=np.float32),
                         np.zeros(3, np.float32))
            self._last_kf = kf
            with self._map_lock:
                self._rebuild_cache()
            self._set_last_frame(pyr, R, t, cache_uv=None)
            return True
        return False


class RgbdTracker(MonoTracker):
    """RGB-D tracking: instant metric initialization from the depth map
    (reference Tracking::StereoInitialization src/Tracking.cc:745-793), then
    the same direct pipeline; new map points are depth-seeded at keyframes
    with triangulation as a complement for far features."""

    # The reference's RGB-D mode always configures Camera.bf (TUM yaml
    # Camera.bf=40) and converts depth to a pseudo-stereo u_r so every
    # depth measurement becomes a 3-D BA edge (Frame::ComputeStereoFromRGBD
    # src/Frame.cc:685-701). Without those edges local BA is mono-only and
    # its scale gauge is pinned only by the fixed ring — scale then drifts
    # a few % over tens of keyframes. When the caller leaves bf unset we
    # synthesize a virtual baseline so depth still anchors scale in BA.
    VIRTUAL_BASELINE_M = 0.08

    def __init__(self, cam: cam_mod.Camera, cfg: TrackerConfig = None):
        if cam.bf <= 0:
            cam = cam._replace(bf=self.VIRTUAL_BASELINE_M * cam.fx)
        super().__init__(cam, cfg)

    def _try_initialize(self, pyr, ts) -> bool:
        if self._cur_depth is None:
            return False
        smap = self.map
        feats = self.extractor(pyr)
        f = self._feats_to_dict(feats)
        if int(f["valid"].sum()) < 100:
            return False
        f["ur"] = self._feature_ur(f, pyr)
        kf0 = smap.add_keyframe(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), f, ts=ts,
                                frame_id=self.frame_id, pyramid=pyr)
        n = self._create_depth_points(smap, kf0, pyr)
        if n < 50:
            return False

        if self.cfg.enable_loop_closing or self.cfg.enable_relocalization:
            from ..backend.bow import BowIndex
            from ..backend.loopclosing import LoopCloser

            desc = f["desc"][f["valid"]]
            vocab = self._build_vocabulary(desc)
            self.bow_index = BowIndex(vocab, max_kf=smap.max_kf)
            self.loop_closer = LoopCloser(self.bow_index, self.cam)
            wid, bow = self.bow_index.quantize(smap.kf_feat_desc[kf0],
                                               smap.kf_feat_valid[kf0])
            self.bow_index.add_keyframe(kf0, bow, feat_wid=wid)

        self.state = State.OK
        self._last_kf = kf0
        self._last_kf_frame = self.frame_id
        self._kf_ref_tracked = n
        self._rebuild_cache()
        self._set_last_frame(pyr, smap.kf_R[kf0], smap.kf_t[kf0],
                             cache_uv=None)
        self._vel = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        return True


    def _feature_ur(self, f, pyr):
        """RGB-D pseudo-stereo: u_r = u - bf/z from the depth map (reference
        Frame::ComputeStereoFromRGBD src/Frame.cc:685-701). Requires
        Camera.bf; without it observations stay monocular (depth still seeds
        points via _create_depth_points)."""
        depth = getattr(self, "_cur_depth", None)
        bf = self.cam.bf
        if depth is None or bf <= 0 or not hasattr(depth, "shape"):
            return np.full(len(f["uv"]), -1.0, np.float32)
        depth = np.asarray(depth)
        uv = np.asarray(f["uv"])
        xi = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
        yi = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
        z = depth[yi, xi]
        ok = np.asarray(f["valid"]) & (z > 0.1) & np.isfinite(z)
        ur = uv[:, 0] - bf / np.maximum(z, 1e-6)
        return np.where(ok, ur, -1.0).astype(np.float32)


class StereoTracker(RgbdTracker):
    """Stereo tracking on rectified pairs: feature depths come from the
    batched disparity search (ops/stereo.py; the reference computes them in
    Frame::ComputeStereoMatches src/Frame.cc:509-682). Initialization and
    point seeding reuse the depth-seeded path (metric scale from baseline)."""

    def track(self, img, ts: float, depth=None, right=None):
        self._cur_right = right
        return super().track(img, ts, depth=depth)

    def _depth_source_available(self) -> bool:
        return getattr(self, "_cur_right", None) is not None

    def _try_initialize(self, pyr, ts) -> bool:
        # reuse the RGB-D instant init; depths come from _feature_depths
        if getattr(self, "_cur_right", None) is None:
            return False
        self._cur_depth = True  # sentinel: RgbdTracker init checks not-None
        ok = super()._try_initialize(pyr, ts)
        self._cur_depth = None
        return ok

    def _feature_ur(self, f, pyr):
        """Stereo: batched disparity search for every feature against the
        current right image (reference Frame::ComputeStereoMatches
        src/Frame.cc:509-682); u_r = u - disparity."""
        from ..ops.stereo import stereo_match_features
        from ..ops.image import level0

        right = getattr(self, "_cur_right", None)
        if right is None or self.cam.bf <= 0:
            return np.full(len(f["uv"]), -1.0, np.float32)
        disp, ok = stereo_match_features(
            level0(pyr, self.cam.height),
            jnp.asarray(right, dtype=jnp.float32),
            jnp.asarray(f["uv"]), jnp.asarray(f["valid"]))
        disp = np.asarray(disp)
        ok = np.asarray(ok) & (disp > 0.1)
        ur = np.asarray(f["uv"])[:, 0] - disp
        return np.where(ok, ur, -1.0).astype(np.float32)

    def _feature_depths(self, smap, kf, slots):
        """Depths from the stored stereo u_r: d = bf / (u - u_r)."""
        bf = self.cam.bf
        assert bf > 0, "stereo requires Camera.bf (baseline * fx)"
        ur = smap.kf_feat_ur[kf, slots]
        u = smap.kf_feat_uv[kf, slots, 0]
        disp = u - ur
        d = np.where((ur >= 0) & (disp > 0.1),
                     bf / np.maximum(disp, 1e-3), -1.0)
        return d.astype(np.float32)
