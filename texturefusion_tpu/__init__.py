"""texturefusion_tpu — a dense RGB-D reconstruction framework on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
THU-luvision/TextureFusion (FlashFusion + online texturing): globally
consistent RGB-D SLAM, chunked TSDF fusion with de/re-integration,
incremental marching cubes, MRF texture view selection, texture atlas
and global color compensation — expressed as batched array programs
with static shapes, optionally sharded over a device mesh.

Layer map (mirrors reference layer map in SURVEY.md §1):
  core/      SE3/camera/geometry primitives         (ref: Eigen/Sophus usage)
  io/        datasets, synthetic scenes, exporters   (ref: Tools/, BasicAPI IO)
  ops/       jitted XLA kernels                      (ref: AVX2 SIMD kernels)
  slam/      tracking, loop closure, FastBA          (ref: GCSLAM/)
  fusion/    chunked TSDF store + meshing            (ref: Structure/, open_chisel)
  texture/   view-selection MRF, atlas, color        (ref: TexMap/Atlas/Patch/mapmap)
  parallel/  device-mesh sharding, distributed BA    (ref: none — new capability)
  models/    end-to-end pipeline entry points        (ref: main.cpp, MobileFusion)
  utils/     config, profiling, checkpointing        (ref: Stopwatch, GlobalParameters)
"""

__version__ = "0.1.0"

from texturefusion_tpu.config import PipelineConfig  # noqa: F401
