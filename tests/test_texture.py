import jax.numpy as jnp
import numpy as np
import pytest

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.fusion.pipeline import TexturedPipeline
from texturefusion_tpu.io import synthetic
from texturefusion_tpu.texture import color as color_ops
from texturefusion_tpu.texture import mrf
from texturefusion_tpu.texture.atlas import Atlas

CFG = tiny_test_config()
INTR = cam.Intrinsics.from_config(CFG.camera)
SCENE = synthetic.BoxRoomScene()


# ----------------------------------------------------------------- MRF


def _simple_problem():
    """4-node chain; two keyframes; node 2 slightly prefers kf B but all
    neighbors prefer A — Potts smoothing should flip it."""
    n, l = 4, 4
    unary = np.full((n, l), 1e9, np.float32)
    label_kf = np.full((n, l), -1, np.int32)
    for i in range(n):
        label_kf[i, 0] = 10  # kf A
        label_kf[i, 1] = 20  # kf B
        unary[i, 0] = 0.1
        unary[i, 1] = 0.5
    unary[2, 0] = 0.5
    unary[2, 1] = 0.4   # prefers B by 0.1 < 2 potts edges × 0.5
    nbrs = np.full((n, 6), n, np.int32)
    for i in range(n - 1):
        nbrs[i, 0] = i + 1
        nbrs[i + 1, 1] = i
    parity = np.arange(n, dtype=np.int32) % 2
    problem = mrf.MRFProblem(
        unary=jnp.asarray(unary), label_kf=jnp.asarray(label_kf),
        neighbors=jnp.asarray(nbrs), parity=jnp.asarray(parity),
        init_label=jnp.zeros(n, jnp.int32), n_valid=jnp.ones(n, bool))
    return problem


def test_icm_smooths_labels():
    problem = _simple_problem()
    sol = np.asarray(mrf.solve_icm(problem, 1.0, 0.5, sweeps=8))
    assert (sol == 0).all(), sol  # everyone converges to kf A


def test_icm_never_increases_energy():
    problem = _simple_problem()
    e_init = float(mrf.mrf_energy(problem, problem.init_label, 1.0, 0.5))
    sol = mrf.solve_icm(problem, 1.0, 0.5, sweeps=8)
    e_final = float(mrf.mrf_energy(problem, sol, 1.0, 0.5))
    assert e_final <= e_init + 1e-6


def test_icm_respects_strong_unary():
    problem = _simple_problem()
    unary = np.asarray(problem.unary).copy()
    unary[2, 1] = 0.0
    unary[2, 0] = 10.0  # overwhelming preference for B
    problem = problem._replace(unary=jnp.asarray(unary))
    sol = np.asarray(mrf.solve_icm(problem, 1.0, 0.5, sweeps=8))
    assert sol[2] == 1


def test_view_selector_end_to_end():
    sel = mrf.ViewSelector(max_labels=4)
    observations = {0: {0: 5.0, 1: 1.0}, 1: {0: 4.0}, 2: {1: 3.0}, 3: {}}
    adjacency = {0: np.asarray([1]), 1: np.asarray([0, 2]),
                 2: np.asarray([1, 3]), 3: np.asarray([2])}
    ids = np.zeros((10, 3), np.int32)
    ids[:4, 0] = np.arange(4)
    labels = sel.select(observations, adjacency, ids, newest_kf=3)
    assert labels[0] == 0 and labels[1] == 0
    assert labels[2] == 1
    assert labels[3] in (0, 1, 2)   # fallback for unobserved
    # warm start stored
    assert sel.labels[0] == 0


# ----------------------------------------------------------------- color


def test_color_compensation_fixes_global_shift():
    rng = np.random.default_rng(0)
    vox = rng.uniform(0.2, 0.8, (500, 3)).astype(np.float32)
    tex = np.clip(vox * 0.8 + 0.15, 0, 1).astype(np.float32)  # linear distortion
    cluster = np.zeros(500, np.int32)
    delta = np.asarray(color_ops.compensate(
        jnp.asarray(tex), jnp.asarray(vox), jnp.ones(500),
        jnp.asarray(cluster), 1))
    corrected = tex + delta
    # corrected distribution matches voxel distribution
    np.testing.assert_allclose(corrected.mean(0), vox.mean(0), atol=0.02)
    np.testing.assert_allclose(np.cov(corrected.T), np.cov(vox.T), atol=0.02)


# ----------------------------------------------------------------- atlas


def test_atlas_alloc_blit_uv_roundtrip():
    atlas = Atlas(CFG.texture, CFG.tsdf.voxel_resolution)
    rgb = np.zeros((INTR.height, INTR.width, 3), np.float32)
    rgb[:, :, 0] = np.linspace(0, 1, INTR.width)[None, :]
    rec = atlas.add_or_update_patch(7, 0, np.asarray([10.0, 20.0]),
                                    np.asarray([50.0, 60.0]), rgb)
    assert rec is not None
    uvs = atlas.atlas_uv(7, np.asarray([[10.0, 20.0], [50.0, 60.0]]))
    assert (uvs >= 0).all() and (uvs <= 1).all()
    # sample atlas at the uv of the left edge: red ≈ 10/width
    px = int(uvs[0, 0] * atlas.size)
    py = int((1 - uvs[0, 1]) * atlas.size)
    red = atlas.image[py, px, 0] / 255.0
    assert abs(red - 10.0 / INTR.width) < 0.1
    atlas.release(7)
    assert 7 not in atlas.patches


def test_atlas_overflow():
    small = CFG.texture.__class__(atlas_size=64, patch_scale=1000.0)
    atlas = Atlas(small, 0.05)   # patch 50px → 1 slot in 64px atlas
    rgb = np.ones((INTR.height, INTR.width, 3), np.float32)
    assert atlas.add_or_update_patch(0, 0, np.zeros(2), np.ones(2) * 5, rgb)
    assert atlas.add_or_update_patch(1, 0, np.zeros(2), np.ones(2) * 5, rgb) is None
    assert atlas.overflowed


def test_export_samples_last_materialized_atlas_row(tmp_path):
    """A patch in the last materialized band of the row-lazy atlas, with
    vertices on its bottom edge, samples and exports without indexing
    past the materialized image."""
    import types

    from texturefusion_tpu.texture.manager import ChunkTexture, TextureManager

    mgr = TextureManager(CFG)
    atlas = mgr.atlas
    rows = atlas.image.shape[0]
    rgb = np.full((INTR.height, INTR.width, 3), 0.5, np.float32)
    lo, hi = np.asarray([4.0, 4.0]), np.asarray([40.0, 40.0])
    chunk = 0
    while True:     # fill slots until one lands in the last band
        rec = atlas.add_or_update_patch(chunk, 0, lo, hi, rgb)
        if atlas._slot_origin(rec.slot_index)[1] + atlas.patch_size == rows:
            break
        chunk += 1
    assert atlas.image.shape[0] == rows      # still un-grown
    uv_img = np.asarray([[4.0, 4.0], [40.0, 40.0], [22.0, 40.0]])
    tex = ChunkTexture()
    tex.atlas_uv = atlas.atlas_uv(chunk, uv_img)
    mgr.chunk_tex[chunk] = tex
    verts = np.zeros((3, 3), np.float32)
    faces = np.asarray([[0, 1, 2]], np.int32)
    mesher = types.SimpleNamespace(meshes={chunk: (
        verts, faces, np.zeros((3, 3), np.float32),
        np.zeros((3, 3), np.float32))})
    samples = mgr._sample_atlas(tex.atlas_uv)
    np.testing.assert_allclose(samples, 128 / 255.0, atol=1 / 255.0)
    obj = mgr.export_textured(mesher, str(tmp_path))
    assert open(obj).read().count("\nf ") == 1


# ----------------------------------------------------------------- full


@pytest.fixture(scope="module")
def textured_run():
    poses = synthetic.orbit_trajectory(10)
    depths, rgbs = synthetic.render_sequence(SCENE, INTR, poses)
    pipe = TexturedPipeline(CFG)
    for i in range(len(poses)):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
    pipe.finish()
    pipe._texture_cycle()
    return pipe


def test_textured_pipeline_assigns_labels(textured_run):
    pipe = textured_run
    labeled = [t for t in pipe.texture.chunk_tex.values() if t.label >= 0]
    assert len(labeled) > 5
    with_uv = [t for t in labeled if t.atlas_uv is not None]
    assert len(with_uv) > 5


def test_textured_export(textured_run, tmp_path):
    pipe = textured_run
    obj = pipe.export_textured(str(tmp_path))
    assert obj.endswith(".obj")
    content = open(obj).read()
    assert "vt " in content and "f " in content
    import os
    assert os.path.exists(str(tmp_path / "model.png"))


def test_export_writes_per_vertex_compensated_colors(textured_run, tmp_path):
    """The OBJ export carries per-vertex corrected colors (ref packs the
    per-vertex compensation for its shader, Chisel.cpp:270-284) and the
    deltas are recorded on each chunk's ChunkTexture.color_adjust."""
    pipe = textured_run
    obj = pipe.export_textured(str(tmp_path / "pv"))
    v_lines = [ln for ln in open(obj) if ln.startswith("v ")]
    assert v_lines and all(len(ln.split()) == 7 for ln in v_lines)
    cols = np.asarray([[float(x) for x in ln.split()[4:7]]
                       for ln in v_lines])
    assert np.isfinite(cols).all() and (cols >= 0).all() and (cols <= 1).all()
    adj = [t.color_adjust for t in pipe.texture.chunk_tex.values()
           if t.color_adjust is not None]
    assert adj, "no per-vertex color-adjust deltas recorded"


def test_wrong_mapping_vertices_fall_back_to_voxel_color(textured_run,
                                                         tmp_path):
    """Vertices whose keyframe projection is invalid must export the
    fused voxel color (ref: draw_mesh.vert:29-70 wrong-mapping path)."""
    pipe = textured_run
    tex_mgr = pipe.texture
    # pick an exported chunk and invalidate its first vertices
    slot = next(s for s in sorted(tex_mgr.chunk_tex)
                if tex_mgr.chunk_tex[s].atlas_uv is not None
                and s in pipe.mesher.meshes)
    tex = tex_mgr.chunk_tex[slot]
    n = len(tex.atlas_uv)
    tex.uv_valid = np.zeros(n, bool)          # all wrong
    obj = pipe.export_textured(str(tmp_path / "wm"))
    v_lines = [ln for ln in open(obj) if ln.startswith("v ")]
    cols = np.asarray([[float(x) for x in ln.split()[4:7]]
                       for ln in v_lines])
    # locate this chunk's block in the concatenated export
    base = 0
    for s in sorted(tex_mgr.chunk_tex):
        t = tex_mgr.chunk_tex[s]
        if t.atlas_uv is None or s not in pipe.mesher.meshes:
            continue
        k = min(len(pipe.mesher.meshes[s][0]), len(t.atlas_uv))
        if s == slot:
            vox = pipe.mesher.meshes[s][2][:k]
            np.testing.assert_allclose(cols[base:base + k], vox, atol=5e-3)
            return
        base += k
    raise AssertionError("chunk not found in export")
