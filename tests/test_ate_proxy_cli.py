"""End-to-end CLI run over a generated fr1-proxy TUM dataset:
associate.txt → pack_frame → pipeline → trajectory.txt →
ATE, through `texturefusion_tpu.__main__` — the EXACT path a real TUM
sequence would take (ref: BasicAPI.cpp:1032-1134, main.cpp:102-317).

Scaled down (QQVGA-ish, short arc) to stay CPU-runnable; the full-size
proxy run lives in examples/make_tum_proxy.py + docs/ATE_PROXY.md.
"""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def test_cli_on_fr1_proxy(tmp_path, monkeypatch):
    sys.path.insert(0, _EXAMPLES)
    import make_tum_proxy as mk

    # shrink to test scale: quarter resolution, short arc
    monkeypatch.setitem(mk.FR1_CAMERA, "width", 160)
    monkeypatch.setitem(mk.FR1_CAMERA, "height", 120)
    monkeypatch.setitem(mk.FR1_CAMERA, "fx", 517.3 / 4)
    monkeypatch.setitem(mk.FR1_CAMERA, "fy", 516.5 / 4)
    monkeypatch.setitem(mk.FR1_CAMERA, "cx", 318.6 / 4)
    monkeypatch.setitem(mk.FR1_CAMERA, "cy", 255.3 / 4)
    root = str(tmp_path / "seq")
    mk.generate(root, n_frames=10)

    # the on-disk artifacts a TUM user expects
    for f in ("associate.txt", "groundtruth.txt", "calib.txt",
              "rgb.txt", "depth.txt"):
        assert os.path.exists(os.path.join(root, f)), f

    from texturefusion_tpu.__main__ import main as cli_main
    out = str(tmp_path / "out")
    rc = cli_main([root, "", "0.05", "0", "--out", out, "--no-texture"])
    assert rc == 0

    # trajectory.txt in TUM format, evaluable against groundtruth.txt
    traj_path = os.path.join(out, "trajectory.txt")
    assert os.path.exists(traj_path)
    from texturefusion_tpu.io import tum
    est_ts, est = tum.read_trajectory(traj_path)
    gt_ts, gt = tum.read_trajectory(os.path.join(root, "groundtruth.txt"))
    pairs = tum.associate_timestamps(est_ts, gt_ts, max_dt=0.05)
    assert len(pairs) >= 8
    ate = tum.ate_rmse(est[[i for i, _ in pairs]], gt[[j for _, j in pairs]])
    # quantized+shadowed sensor at 160x120 over a short arc: the gate is
    # deliberately loose — this test guards the PATH end-to-end, the
    # bench regression test guards accuracy at scale
    assert ate < 0.10, f"proxy ATE {ate * 1e3:.1f} mm"
    assert os.path.exists(os.path.join(out, "fused.ply"))
    assert os.path.exists(os.path.join(out, "stat.txt"))
