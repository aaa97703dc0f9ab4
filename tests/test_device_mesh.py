"""Device meshes never fall back to fewer devices than asked for."""

import pytest

from texturefusion_tpu.config import ParallelConfig, tiny_test_config
from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
from texturefusion_tpu.parallel.mesh import make_mesh


@pytest.mark.parametrize("n", [1, 4, 8])
def test_make_mesh_uses_the_first_n_devices(n):
    import jax

    mesh = make_mesh(n)
    assert list(mesh.devices) == jax.devices()[:n]


def test_make_mesh_raises_when_devices_are_missing():
    with pytest.raises(ValueError, match="asked for 9 devices"):
        make_mesh(9)


def test_sharded_pipeline_raises_when_devices_are_missing():
    cfg = tiny_test_config().replace(
        parallel=ParallelConfig(tsdf_sharded=True, n_devices=16))
    with pytest.raises(ValueError, match="asked for 16 devices"):
        ReconstructionPipeline(cfg)
