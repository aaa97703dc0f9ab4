"""9x9 bilateral depth filter (ops/preprocess.bilateral_filter) against an
independent per-pixel loop, with holes and edge-replicated borders."""

import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.ops.preprocess import bilateral_filter


def _bilateral_loop(d, radius=4, sigma_space=4.5, sigma_range=0.03):
    """Plain per-pixel definition: taps outside the image take the
    nearest edge pixel; invalid (0) taps and centres contribute nothing."""
    h, w = d.shape
    out = np.zeros_like(d, dtype=np.float64)
    for y in range(h):
        for x in range(w):
            c = float(d[y, x])
            if c <= 0:
                continue
            acc = wsum = 0.0
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    nb = float(d[min(max(y + dy, 0), h - 1),
                                 min(max(x + dx, 0), w - 1)])
                    if nb <= 0:
                        continue
                    wgt = (np.exp(-(dy * dy + dx * dx)
                                  / (2 * sigma_space ** 2))
                           * np.exp(-(nb - c) ** 2 / (2 * sigma_range ** 2)))
                    acc += wgt * nb
                    wsum += wgt
            out[y, x] = acc / wsum if wsum > 1e-12 else 0.0
    return out


def test_bilateral_matches_loop_with_holes_and_borders():
    rng = np.random.default_rng(0)
    d = rng.uniform(1.0, 1.1, (21, 26)).astype(np.float32)
    d[:, 13:] += 0.4                       # a depth step
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    d[0, :5] = 0.0                         # holes on the border
    got = np.asarray(bilateral_filter(jnp.asarray(d)))
    ref = _bilateral_loop(d)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert ((got == 0) == (d == 0)).all()  # holes stay holes


def test_bilateral_preserves_edges():
    d = np.full((48, 64), 2.0, np.float32)
    d[:, 32:] = 1.0
    out = np.asarray(bilateral_filter(jnp.asarray(d)))
    # range kernel (sigma 0.03) must not blur a 1 m depth step
    assert abs(out[24, 31] - 2.0) < 1e-3
    assert abs(out[24, 32] - 1.0) < 1e-3
