"""chip_smoke.py's own logic on the CPU: the device check, Phase A's
comparator and the contract's last line. The phases themselves need a GPU
and run there (`python chip_smoke.py`)."""
import json
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from ygz_tpu.frontend.framestep import N_SCALARS  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_phase_a_comparator_cpu_vs_cpu():
    cpu = jax.devices("cpu")[0]
    cap = 64
    fixture = chip_smoke.scene_fixture(batch=2, cap=cap)
    ref = chip_smoke.run_frame_step(cpu, fixture)
    got = chip_smoke.run_frame_step(cpu, fixture)
    m, failures = chip_smoke.compare_frame_steps(ref, got, cap)
    assert failures == [], (m, failures)
    assert m["n_tracked_pairs"] > 0          # the fixture really tracks

    bad = got.copy()
    bad[1, 9] += 1e-2                        # frame 1's t_x
    m, failures = chip_smoke.compare_frame_steps(ref, bad, cap)
    assert any("translation" in f for f in failures), (m, failures)
    assert bad.shape[1] == N_SCALARS + 5 * cap


def test_result_line_keys():
    devs = jax.devices("cpu")
    out = json.loads(chip_smoke.result_line(devs))
    assert set(out) == {"ok", "device"}
    assert out["ok"] is True
    assert set(out["device"]) == {"platform", "kind", "count"}
    assert out["device"]["platform"] == devs[0].platform
    assert out["device"]["kind"] == devs[0].device_kind
    assert out["device"]["count"] == len(devs)
