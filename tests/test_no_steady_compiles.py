"""Steady-state compile discipline (SURVEY §7.3, VERDICT r2 #1): after the
early structural phase, a long run must trigger ZERO new XLA compiles —
every mid-run compile stalls the tracking loop for seconds, so a single
late-appearing shape shows up as a latency spike in the steady state."""
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ygz_tpu.geometry import camera as cam_mod, lie
from ygz_tpu.system import System, Sensor
from ygz_tpu.frontend.tracker import TrackerConfig

from synthetic import SmoothScene

N = 200
SETTLE = 120     # compiles allowed up to here (init, first KFs, first
#                  loop/gba bucket); none after


def pose(i):
    s = 3.5 * np.sin(np.pi * i / N)      # out-and-back: revisit + rebind
    yaw = 0.02 * np.sin(i * 0.23)
    R = np.asarray(lie.so3_exp(jnp.asarray(
        np.array([0.0, yaw, 0.0], np.float32))))
    c = np.array([s, 0.12 * np.sin(i * 0.11), 0.0], np.float32)
    return R, (-R @ c).astype(np.float32)


@pytest.mark.slow
def test_no_new_compiles_in_steady_state():
    compiles = []

    class H(logging.Handler):
        def emit(self, r):
            msg = r.getMessage()
            if "Compiling" in msg:
                compiles.append(msg)

    h = H()
    logger = logging.getLogger("jax._src.interpreters.pxla")
    logger.addHandler(h)
    logger.setLevel(logging.WARNING)
    jax.config.update("jax_log_compiles", True)
    try:
        scene = SmoothScene(seed=31, w=480, h=360, f=600.0, tex_size=2400)
        cam = cam_mod.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                  scene.w, scene.h)
        sys_ = System(cam, Sensor.MONOCULAR,
                      config=TrackerConfig(kf_max_gap=10))
        late = []
        for i in range(N):
            R, t = pose(i)
            n0 = len(compiles)
            sys_.track_monocular(scene.render(R, t), timestamp=i * 0.05)
            if i >= SETTLE and len(compiles) > n0:
                late.append((i, compiles[n0:]))
        assert sys_.tracker.state.name == "OK"
        assert not late, (
            f"XLA compiles after frame {SETTLE}: "
            + "; ".join(f"frame {i}: {len(c)}" for i, c in late)
            + " | first: " + late[0][1][0][:300])
    finally:
        jax.config.update("jax_log_compiles", False)
        logger.removeHandler(h)
