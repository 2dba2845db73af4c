"""End-to-end render tests: the minimum slice of SURVEY.md §7 phase 3.

Shadow-trace AOV parity against the brute-force oracle (the Embree role)
and a path-trace smoke/energy test — the same verification shape as the
reference's LITERATE_TEST.ipynb + in-app MSE checks (trace.cpp:528-540).
"""

import numpy as np
import pytest

from ipu_ray_lib_tpu.cpu.reference import oracle_shadow_trace
from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
from ipu_ray_lib_tpu.render.renderer import render
from ipu_ray_lib_tpu.scene.build import build_scene
from ipu_ray_lib_tpu.scene.types import CropWindow
from ipu_ray_lib_tpu.utils.image import mse

SIZE = 48


@pytest.fixture(scope="module")
def built48(cornell_scene):
    return build_scene(cornell_scene, image_width=SIZE, image_height=SIZE)


@pytest.fixture(scope="module")
def shadow_out(built48):
    arrays, params, _ = built48
    return render(arrays, params, mode="shadow-trace", chunk_size=SIZE * SIZE)


@pytest.fixture(scope="module")
def oracle_out(cornell_scene, built48):
    _, params, _ = built48
    rows, cols = pixel_grid(SIZE, SIZE, 0, 0)
    o, d = generate_camera_rays(
        rows, cols, params.image_width, params.image_height, params.fov_radians, 0.0, None
    )
    res = oracle_shadow_trace(cornell_scene, np.asarray(o), np.asarray(d))
    return {k: (v.reshape(SIZE, SIZE, -1) if v.ndim == 2 else v.reshape(SIZE, SIZE)) for k, v in res.items()}


def test_shadow_hit_masks_match(shadow_out, oracle_out):
    ours = shadow_out.geom_id >= 0
    ref = oracle_out["geom"] >= 0
    assert (ours == ref).mean() > 0.995


def test_shadow_rgb_close(shadow_out, oracle_out):
    # Small MSE, like the reference's IPU-vs-Embree check. Shadow boundary
    # pixels may differ (different epsilon conventions), so compare MSE
    # rather than exact:
    assert mse(shadow_out.rgb, oracle_out["rgb"]) < 2e-3


def test_shadow_normals_close(shadow_out, oracle_out):
    both = (shadow_out.geom_id >= 0) & (oracle_out["geom"] >= 0)
    dots = np.abs(np.sum(shadow_out.normal * oracle_out["normal"], axis=-1))[both]
    assert np.quantile(dots, 0.02) > 0.999


def test_shadow_hitpoints_close(shadow_out, oracle_out):
    both = (shadow_out.geom_id >= 0) & (oracle_out["geom"] >= 0)
    err = np.linalg.norm(shadow_out.hit_p - oracle_out["hit_p"], axis=-1)[both]
    assert np.quantile(err, 0.99) < 0.5  # scene units are ~hundreds


def test_shadow_crop_window_matches_full(built48, shadow_out):
    arrays, params, _ = built48
    import dataclasses

    win = CropWindow(16, 12, 8, 20)
    params_crop = dataclasses.replace(
        params, window_w=win.w, window_h=win.h, window_c=win.c, window_r=win.r
    )
    out = render(arrays, params_crop, mode="shadow-trace", chunk_size=win.w * win.h)
    full_region = shadow_out.rgb[win.r : win.r + win.h, win.c : win.c + win.w]
    np.testing.assert_allclose(out.rgb, full_region, rtol=1e-5, atol=1e-6)


def test_path_trace_smoke(cornell_scene):
    import dataclasses

    arrays, params, _ = build_scene(
        cornell_scene, image_width=24, image_height=24, samples_per_pixel=8
    )
    out = render(arrays, params, mode="path-trace", chunk_size=24 * 24)
    img = out.rgb
    assert np.all(np.isfinite(img))
    assert img.max() > 0.05  # light visible somewhere
    assert img.min() >= 0.0
    # Monte-carlo consistency: two seeds give similar mean brightness.
    params2 = dataclasses.replace(params, rng_seed=7)
    out2 = render(arrays, params2, mode="path-trace", chunk_size=24 * 24)
    m1, m2 = img.mean(), out2.rgb.mean()
    assert abs(m1 - m2) / max(m1, m2) < 0.25


def test_path_trace_sorted_wavefront_distribution(cornell_scene):
    """Ray sorting permutes RNG pairing, so images differ per pixel but
    must match in distribution (the reference's RNG-parity standard)."""
    import jax
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
    from ipu_ray_lib_tpu.render.path import path_trace_sample

    arrays, params, _ = build_scene(
        cornell_scene, image_width=32, image_height=32
    )
    rows, cols = pixel_grid(32, 32, 0, 0)
    key = jax.random.PRNGKey(0)

    def run(sort):
        acc = np.zeros((1024, 3), np.float32)
        for s in range(6):
            o, d = generate_camera_rays(
                rows, cols, 32, 32, params.fov_radians, 0.25,
                jax.random.fold_in(key, 100 + s),
            )
            r = path_trace_sample(
                arrays, o, d, jax.random.fold_in(key, s), 6, 3,
                intersector="dense", sort_rays=sort,
            )
            acc += np.asarray(r.rgb)
        return acc / 6

    a = run(False)
    b = run(True)
    assert np.all(np.isfinite(b))
    # Same energy and distribution:
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.15
    ha, _ = np.histogram(a, bins=16, range=(0, 2))
    hb, _ = np.histogram(b, bins=16, range=(0, 2))
    assert np.abs(ha - hb).sum() / max(ha.sum(), 1) < 0.2


def test_streaming_matches_per_sample_energy(cornell_scene):
    """Streaming-regeneration integrator must agree with the per-sample
    wavefront in distribution (independent RNG streams)."""
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params, _ = build_scene(
        cornell_scene, image_width=24, image_height=24,
        samples_per_pixel=32, intersector="dense",
    )
    img, done = render_streaming(arrays, params, chunk_slots=2048)
    assert done == 24 * 24 * 32
    assert np.isfinite(img).all() and img.min() >= 0

    out = render(arrays, params, mode="path-trace", chunk_size=24 * 24,
                 streaming=False)
    a, b = img.mean(), out.rgb.mean()
    assert abs(a - b) / max(b, 1e-9) < 0.12


def test_readback_f16_option(cornell_built, monkeypatch):
    """RAY_READBACK_F16=1 must return the same image at half precision."""
    import dataclasses

    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params, _ = cornell_built
    p = dataclasses.replace(params, window_w=32, window_h=24,
                            samples_per_pixel=2, intersector="dense")
    img32, done = render_streaming(arrays, p, spp=2)
    monkeypatch.setenv("RAY_READBACK_F16", "1")
    img16, done16 = render_streaming(arrays, p, spp=2)
    assert done16 == done
    assert img16.dtype == np.float32            # converted back for callers
    # f16 holds ~3 significant digits:
    np.testing.assert_allclose(img16, img32, rtol=2e-3, atol=2e-3)


def test_bvh_matches_dense_streaming(cornell_scene):
    """Cross-intersector radiometry: the XLA-loop integrator over the
    threaded BVH and over the dense tables shares RNG streams and
    estimator, so with identical seeds they trace the *same* paths up to
    fp differences at decision boundaries — images must agree closely,
    not just in distribution."""
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    imgs = {}
    for intersector in ("bvh", "dense"):
        arrays, params, _ = build_scene(
            cornell_scene, image_width=48, image_height=32,
            samples_per_pixel=8, intersector=intersector,
        )
        imgs[intersector], done = render_streaming(arrays, params, spp=8)
        assert done == 48 * 32 * 8
    a, b = imgs["bvh"], imgs["dense"]
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) < 0.02
    # The overwhelming majority of pixels must agree to fp-noise level;
    # a handful may diverge where a roulette/hit decision flipped:
    d = np.abs(a - b).max(axis=-1)
    assert float(np.quantile(d, 0.99)) < 2e-2, float(np.quantile(d, 0.99))


def test_shadow_bvh_matches_oracle(cornell_scene, oracle_out):
    """The shadow path over the BVH intersector (closest hit + any-hit
    occlusion walk) must match the f64 oracle AOVs too — the fixtures
    above render with the dense intersector ``auto`` picks here."""
    arrays, params, _ = build_scene(
        cornell_scene, image_width=SIZE, image_height=SIZE,
        intersector="bvh",
    )
    out = render(arrays, params, mode="shadow-trace", chunk_size=SIZE * SIZE)
    ours = out.geom_id >= 0
    ref = oracle_out["geom"] >= 0
    assert (ours == ref).mean() > 0.995
    both = ours & ref
    assert mse(out.rgb[both], oracle_out["rgb"][both]) < 2e-3
    dots = np.abs(np.sum(out.normal * oracle_out["normal"], axis=-1))[both]
    assert np.quantile(dots, 0.01) > 0.999


def test_f16_readback_shadow_aovs(cornell_built, monkeypatch):
    """RAY_READBACK_F16 on the shadow-trace AOV readback (large-frame
    shadow mode moves six AOVs per pixel to the host): float AOVs
    must match the f32 readback to half precision; integer AOVs (geom /
    prim ids) must stay exact."""
    import dataclasses

    import numpy as np

    from ipu_ray_lib_tpu.render.renderer import render

    arrays, params, _ = cornell_built
    p = dataclasses.replace(params, window_w=32, window_h=32,
                            window_c=48, window_r=48)
    base = render(arrays, p, mode="shadow-trace", chunk_size=512)
    monkeypatch.setenv("RAY_READBACK_F16", "1")
    half = render(arrays, p, mode="shadow-trace", chunk_size=512)
    np.testing.assert_array_equal(half.geom_id, base.geom_id)
    np.testing.assert_array_equal(half.prim_id, base.prim_id)
    np.testing.assert_allclose(half.normal, base.normal, atol=2e-3)
    np.testing.assert_allclose(half.rgb, base.rgb, rtol=2e-3, atol=2e-3)
    finite = np.isfinite(base.t)
    np.testing.assert_allclose(half.t[finite], base.t[finite], rtol=2e-3)
