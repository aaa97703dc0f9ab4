"""chip_smoke.py: the GPU gate, and its phases as `gpu` tests (they
skip without a card; `python chip_smoke.py` runs the same functions)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_smoke_refuses_a_cpu_device(capsys, argv):
    assert chip_smoke.main(argv) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs a GPU" in err


@pytest.fixture(scope="module")
def frames(gpu):
    return chip_smoke.bench_frames()


@pytest.mark.gpu
def test_stage_parity_on_gpu(frames):
    config, packed, gt, _ = frames
    chip_smoke.phase_stage_parity(config, packed, gt)


@pytest.mark.gpu
def test_cli_end_to_end_on_gpu(gpu, tmp_path):
    chip_smoke.phase_cli(str(tmp_path))


@pytest.mark.gpu
def test_bench_pipeline_on_gpu(frames):
    chip_smoke.phase_bench_pipeline(*frames)
