"""Invariances of the streaming integrator, for both intersectors.

* The slot count (``chunk_slots``) does not change the image: path ids
  are a function of (pixel, sample) alone, so any slot pool gives the
  bitwise-same render.
* Progressive rendering through ``render(progress_callback=...)`` ends on
  the image a one-shot render with the same batch size gives.
* Done counts equal window pixels x spp on crop windows.
* Same seed, same image; another seed, another image.
* ``render_streaming_sharded`` on 1, 2, 4 and 8 virtual devices agrees
  with the one-device render (per-replica RNG streams differ, so in
  mean, not bitwise) and completes every path.
"""

import dataclasses

import numpy as np
import pytest

INTERSECTORS = ["dense", "bvh"]


@pytest.fixture(scope="module")
def box_scene():
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene

    return make_cornell_box_scene(None, box_only=False)


def _built(scene, intersector, **kw):
    from ipu_ray_lib_tpu.scene.build import build_scene

    kw.setdefault("image_width", 48)
    kw.setdefault("image_height", 32)
    kw.setdefault("samples_per_pixel", 2)
    return build_scene(scene, intersector=intersector, **kw)[:2]


@pytest.mark.parametrize("chunk_slots", [64, 256, 1536])
@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_chunk_slots_bitwise_invariant(box_scene, intersector, chunk_slots):
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params = _built(box_scene, intersector)
    ref, done_ref = render_streaming(arrays, params, chunk_slots=48 * 32)
    img, done = render_streaming(arrays, params, chunk_slots=chunk_slots)
    assert done == done_ref == 48 * 32 * 2
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_progressive_equals_one_shot(box_scene, intersector):
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    # render() streams batches of 16 spp; the one-shot render uses the
    # same batch size and therefore the same per-batch seeds:
    arrays, params = _built(box_scene, intersector, image_width=24,
                            image_height=24, samples_per_pixel=32,
                            max_path_length=4)
    frames = []
    out = render(arrays, params, mode="path-trace",
                 progress_callback=lambda bi, im: frames.append(im.copy()))
    one, done = render_streaming(arrays, params, spp_batch=16)
    assert done == 24 * 24 * 32
    assert len(frames) == 2
    np.testing.assert_allclose(frames[-1], one, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.rgb, one, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window", [(16, 12, 8, 20), (7, 5, 40, 3)])
@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_done_counts_on_crop_windows(box_scene, intersector, window):
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params = _built(box_scene, intersector, samples_per_pixel=3)
    w, h, c, r = window
    p = dataclasses.replace(params, window_w=w, window_h=h, window_c=c,
                            window_r=r)
    # A slot pool that does not divide the window leaves padding slots:
    img, done = render_streaming(arrays, p, chunk_slots=32)
    assert img.shape == (h, w, 3)
    assert done == w * h * 3
    assert np.isfinite(img).all() and img.min() >= 0


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_seed_determinism(box_scene, intersector):
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params = _built(box_scene, intersector)
    a, _ = render_streaming(arrays, params)
    b, _ = render_streaming(arrays, params)
    c, _ = render_streaming(arrays, params, seed=params.rng_seed + 1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_sharded_matches_one_device(box_scene, intersector, n_dev):
    import jax

    from ipu_ray_lib_tpu.parallel.mesh import (make_ray_mesh,
                                               render_streaming_sharded)
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    # 64 spp: the crop sees the light directly, and its emission spikes
    # make lower-spp means of two independent streams differ by >10%:
    arrays, params = _built(box_scene, intersector, image_width=64,
                            image_height=64, samples_per_pixel=64)
    p = dataclasses.replace(params, window_w=32, window_h=32, window_c=16,
                            window_r=16)
    mesh = make_ray_mesh(jax.devices()[:n_dev])
    img_sh, done = render_streaming_sharded(arrays, p, mesh, chunk_slots=128)
    img_1, done_1 = render_streaming(arrays, p, chunk_slots=1024)
    assert done == done_1 == 32 * 32 * 64
    assert np.isfinite(img_sh).all()
    assert abs(img_sh.mean() - img_1.mean()) / img_1.mean() < 0.1
    rmse = float(np.sqrt(((img_sh - img_1) ** 2).mean()))
    assert rmse < 0.25, rmse
