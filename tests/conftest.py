"""Test configuration: run everything on a virtual 8-device CPU mesh.

GPU execution is exercised separately by chip_smoke.py and bench.py; unit and
integration tests must be hermetic and able to validate multi-device sharding
without hardware (SURVEY.md §4 test strategy, item d).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"

# persistent compilation cache: the suite is dominated by jit compiles
# (~16 min cold in round 1); cached recompiles cut repeat runs severalfold
from ygz_tpu.utils.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()
