import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import CameraConfig
from texturefusion_tpu.core import camera


INTR = camera.Intrinsics.from_config(CameraConfig())


def test_project_unproject_roundtrip():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 3.0, (100,)).astype(np.float32)
    u = rng.uniform(0, INTR.width - 1, (100,)).astype(np.float32)
    v = rng.uniform(0, INTR.height - 1, (100,)).astype(np.float32)
    pts = camera.unproject(INTR, jnp.asarray(u), jnp.asarray(v), jnp.asarray(depth))
    uv, z = camera.project(INTR, pts)
    np.testing.assert_allclose(np.asarray(uv[..., 0]), u, atol=1e-3)
    np.testing.assert_allclose(np.asarray(uv[..., 1]), v, atol=1e-3)
    np.testing.assert_allclose(np.asarray(z), depth, atol=1e-5)


def test_backproject_depth_map_shape():
    depth = jnp.ones((INTR.height, INTR.width), jnp.float32) * 2.0
    pts = camera.backproject_depth_map(INTR, depth)
    assert pts.shape == (INTR.height, INTR.width, 3)
    # center pixel should point approximately down +z
    c = np.asarray(pts[INTR.height // 2, INTR.width // 2])
    assert abs(c[2] - 2.0) < 1e-5
    assert abs(c[0]) < 0.01 and abs(c[1]) < 0.01


def test_bilinear_sample_exact_on_grid():
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    uv = jnp.asarray([[1.0, 2.0], [0.0, 0.0], [3.0, 2.0]])
    val, mask = camera.bilinear_sample(jnp.asarray(img), uv)
    np.testing.assert_allclose(np.asarray(val), [9.0, 0.0, 11.0], atol=1e-6)
    assert np.all(np.asarray(mask))


def test_bilinear_sample_interpolates():
    img = np.array([[0.0, 1.0], [2.0, 3.0]], dtype=np.float32)
    val, _ = camera.bilinear_sample(jnp.asarray(img), jnp.asarray([[0.5, 0.5]]))
    np.testing.assert_allclose(np.asarray(val), [1.5], atol=1e-6)


def test_bilinear_sample_out_of_bounds():
    img = np.ones((4, 4), dtype=np.float32)
    val, mask = camera.bilinear_sample(jnp.asarray(img), jnp.asarray([[-1.0, 0.0], [5.0, 1.0]]))
    assert not np.any(np.asarray(mask))
    np.testing.assert_allclose(np.asarray(val), 0.0)


def test_bilinear_sample_multichannel():
    img = np.random.default_rng(1).uniform(size=(5, 6, 3)).astype(np.float32)
    val, mask = camera.bilinear_sample(jnp.asarray(img), jnp.asarray([[2.0, 3.0]]))
    np.testing.assert_allclose(np.asarray(val)[0], img[3, 2], atol=1e-6)


def test_scaled_intrinsics():
    half = INTR.scaled(0.5)
    assert half.width == INTR.width // 2
    assert abs(half.fx - INTR.fx * 0.5) < 1e-6


def test_in_image():
    uv = jnp.asarray([[0.0, 0.0], [639.0, 479.0], [-0.1, 5.0], [640.0, 5.0]])
    mask = np.asarray(camera.in_image(INTR, uv))
    assert list(mask) == [True, True, False, False]


def test_undistort_roundtrip():
    """undistort(distort(x)) ≈ x for TUM-fr1-like coefficients
    (ref: BasicAPI.cpp:195-241 keypoint undistortion)."""
    import numpy as np
    from texturefusion_tpu.core import camera as cam
    intr = cam.Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                          width=640, height=480, near=0.01, far=6.0,
                          d0=0.2624, d1=-0.9531, d2=-0.0054, d3=0.0026,
                          d4=1.1633)
    rng = np.random.default_rng(0)
    # ideal pixel coords over the central image region
    uv_ideal = np.stack([rng.uniform(80, 560, 200),
                         rng.uniform(60, 420, 200)], -1).astype(np.float32)
    x = (uv_ideal[:, 0] - intr.cx) / intr.fx
    y = (uv_ideal[:, 1] - intr.cy) / intr.fy
    xd, yd = cam.distort_normalized(intr, jnp.asarray(x), jnp.asarray(y))
    uv_dist = jnp.stack([xd * intr.fx + intr.cx,
                         yd * intr.fy + intr.cy], axis=-1)
    back = np.asarray(cam.undistort_points(intr, uv_dist))
    np.testing.assert_allclose(back, uv_ideal, atol=0.05)


def test_undistort_noop_without_coeffs():
    import numpy as np
    from texturefusion_tpu.core import camera as cam
    intr = cam.Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                          width=640, height=480, near=0.01, far=6.0)
    uv = jnp.asarray(np.random.default_rng(1).uniform(0, 600, (50, 2))
                     .astype(np.float32))
    assert cam.undistort_points(intr, uv) is uv


def test_distorted_registration_recovers_pose():
    """Two views of the same points observed through a DISTORTED camera:
    backprojection via undistorted keypoints must let Kabsch/GN recover
    the ground-truth relative pose."""
    import numpy as np
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.core import se3

    intr = cam.Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                          width=640, height=480, near=0.01, far=6.0,
                          d0=0.2624, d1=-0.9531, d2=-0.0054, d3=0.0026,
                          d4=1.1633)
    rng = np.random.default_rng(2)
    pts_w = rng.uniform(-0.8, 0.8, (120, 3)).astype(np.float32)
    pts_w[:, 2] += 2.5
    xi = jnp.asarray(np.asarray([0.05, -0.03, 0.02, 0.04, -0.02, 0.03],
                                np.float32))
    t_rel = np.asarray(se3.se3_exp(xi))     # frame1 → frame0

    def observe(t_w2c):
        p_cam = pts_w @ t_w2c[:3, :3].T + t_w2c[:3, 3]
        # distorted pixel observation
        x = p_cam[:, 0] / p_cam[:, 2]
        y = p_cam[:, 1] / p_cam[:, 2]
        xd, yd = cam.distort_normalized(intr, jnp.asarray(x), jnp.asarray(y))
        uv_d = jnp.stack([xd * intr.fx + intr.cx,
                          yd * intr.fy + intr.cy], axis=-1)
        # the pipeline's recovery path: undistort → pinhole backproject
        uv_i = cam.undistort_points(intr, uv_d)
        return np.asarray(cam.unproject(intr, uv_i[:, 0], uv_i[:, 1],
                                        jnp.asarray(p_cam[:, 2])))

    p0 = observe(np.eye(4, dtype=np.float32))           # points in frame 0
    p1 = observe(np.linalg.inv(t_rel).astype(np.float32))  # in frame 1
    # Kabsch on recovered 3D points must give t_rel: p0 ≈ T · p1, and
    # kabsch(p, q) fits p ≈ R q + t
    from texturefusion_tpu.slam.matching import kabsch
    t_est = np.asarray(kabsch(jnp.asarray(p0), jnp.asarray(p1),
                              jnp.ones(len(p0))))
    err = np.abs(t_est - t_rel).max()
    assert err < 2e-3, f"pose error {err} — undistortion broken"
