"""Golden-image radiometry regression.

Pins the absolute radiometry of the streaming integrator (acceptance
chain, RNG streams, shading, banking, env light) on three scenes at tiny
sizes on the CPU backend: Cornell box + plinth (``dense``), spheres lit
by the in-repo NIF (``dense`` + the bf16 env MLP), and the stress
heightfield (``bvh``).

Tolerance, not hashes: XLA CPU codegen may drift a ulp across toolchain
upgrades; real radiometry bugs (payload leaks, RNG stream changes,
acceptance-band edits) move pixels by far more than 1e-5. An
INTENTIONAL estimator change must regenerate the assets (command below)
and say so in the commit.

Regenerate:
    JAX_PLATFORMS=cpu python - <<'EOF'
    import numpy as np
    from tests.test_golden import CASES, render_case
    for name in CASES:
        np.save(f'tests/golden/{name}.npy', render_case(name)[0])
    EOF
"""

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.join(os.path.dirname(__file__), "..")

# name -> (scene, width, height, max_path_length, intersector, nif asset)
CASES = {
    "box48x32_spp2": ("box", 48, 32, 10, "dense", None),
    "spheres_nif48x32_spp2": ("spheres", 48, 32, 10, "dense",
                              "assets/nif/synthetic_urban_4k"),
    "stress24_hbm32x32_spp2": ("stress24", 32, 32, 4, "bvh", None),
}


def render_case(name, intersector=None):
    """Render golden case ``name`` at spp 2; returns (rgb, done)."""
    from ipu_ray_lib_tpu.render.streaming import render_streaming
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import (make_cornell_box_scene,
                                               make_primitive_scene,
                                               make_stress_scene)

    scene_name, w, h, mpl, its, nif = CASES[name]
    scene = {
        "box": lambda: make_cornell_box_scene(None, box_only=False),
        "spheres": make_primitive_scene,
        "stress24": lambda: make_stress_scene(24),
    }[scene_name]()
    env_fn = env_params = None
    if nif is not None:
        from ipu_ray_lib_tpu.nif import load_nif_env

        env_fn, env_params = load_nif_env(os.path.join(ROOT, nif))
    arrays, params, _ = build_scene(
        scene, image_width=w, image_height=h, samples_per_pixel=2,
        max_path_length=mpl, intersector=intersector or its)
    rgb, done = render_streaming(arrays, params, spp=2, env_fn=env_fn,
                                 env_params=env_params)
    return np.asarray(rgb), done


def _check(name):
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npy"))
    rgb, done = render_case(name)
    assert done == golden.shape[0] * golden.shape[1] * 2
    np.testing.assert_allclose(rgb, golden, rtol=1e-5, atol=1e-5)


def test_golden_box_radiometry():
    _check("box48x32_spp2")


def test_golden_spheres_nif_radiometry():
    """Spheres + NIF env light: the analytic primitives and the bf16 env
    MLP, which the Cornell golden cannot see."""
    _check("spheres_nif48x32_spp2")


def test_golden_hbm_radiometry():
    """The 1,058-triangle stress heightfield through the BVH walk (the
    file name keeps the layout it was first recorded with)."""
    _check("stress24_hbm32x32_spp2")
