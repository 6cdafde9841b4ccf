"""ygz_tpu — an accelerator-native visual(-inertial) SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capability surface of ORB-YGZ-SLAM
(the reference: C++/SSE, 4-thread CPU design): mono/stereo/RGB-D feature
SLAM + SVO-style sparse direct tracking + IMU preintegration / VIO.

Design stance (see SURVEY.md §7):
  * Map state is struct-of-arrays with fixed capacities + validity masks,
    not pointer graphs; all numerics are pure jitted functions.
  * Front-end (pyramid, FAST, BRIEF, patch alignment, matching) is batched
    over points/tiles; descriptors matched via a ±1 matmul.
  * Bundle adjustment is batched Gauss-Newton with dense-block Schur
    complement; distributed BA shards observations over a jax Mesh.
"""

__version__ = "0.1.0"

import jax as _jax

# SLAM's normal equations (J^T W J assembly, 6x6/Schur solves, patch
# Hessians) need true float32. On a GPU, XLA may otherwise run float32
# matmuls in TF32, which keeps ~10 mantissa bits; tracking at that
# precision is unmeasured, so full float32 holds process-wide until
# precision is chosen per call site. The affected contractions are tiny
# (<=6x6 blocks batched), so full float32 costs little there.
_jax.config.update("jax_default_matmul_precision", "float32")
