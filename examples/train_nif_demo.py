#!/usr/bin/env python
"""NIF neural-rendering demo: train an environment NIF and render with it.

End-to-end reproduction of the reference's NIF workflow
(ref README.md "Neural Environment Lighting" + assets/nif): train a
Fourier-feature MLP on an HDRI, save reference-compatible assets, and
path-trace the primitive "spheres" scene lit by the neural environment.

If no HDRI path is given, a synthetic sky (gradient + sun disc) is used.

Usage:
  python examples/train_nif_demo.py [--hdri image.exr] [--steps 3000]
                                    [--out /tmp/nif_demo]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def synthetic_hdri(h=128, w=256):
    """Gradient sky + warm sun disc, HDR range."""
    theta = np.linspace(0, np.pi, h)[:, None]          # 0 = up
    phi = np.linspace(0, 2 * np.pi, w)[None, :]
    sky_t = np.clip(np.cos(theta), 0, 1)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.20 + 0.3 * sky_t                   # r
    img[..., 1] = 0.35 + 0.45 * sky_t                  # g
    img[..., 2] = 0.65 + 0.35 * sky_t                  # b
    # ground bounce:
    img[theta[:, 0] > np.pi / 2, :] = [0.25, 0.2, 0.15]
    # sun at theta=pi/4, phi=pi/3:
    d = np.sqrt((theta - np.pi / 4) ** 2 + (phi - np.pi / 3) ** 2)
    img += np.where(d[..., None] < 0.08, 60.0, 0.0)
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hdri", default="", help="HDR image to fit (exr)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--layer-size", type=int, default=64)
    ap.add_argument("--layer-count", type=int, default=4)
    ap.add_argument("--embedding-dim", type=int, default=8)
    ap.add_argument("--out", default="/tmp/nif_demo")
    ap.add_argument("--size", type=int, default=128, help="render size")
    ap.add_argument("--spp", type=int, default=64)
    args = ap.parse_args()

    from ipu_ray_lib_tpu.nif.model import load_nif_env
    from ipu_ray_lib_tpu.nif.train import save_nif_assets, train_nif
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene
    from ipu_ray_lib_tpu.utils.image import read_image, write_image
    from ipu_ray_lib_tpu.utils.profiling import analyse_model

    if args.hdri:
        img = read_image(args.hdri)
    else:
        img = synthetic_hdri()
        print("# Using synthetic sky HDRI (128x256)")

    print(f"# Training NIF: {args.layer_count}x{args.layer_size}, "
          f"E={args.embedding_dim}, {args.steps} steps")
    model, meta = train_nif(
        img,
        embedding_dimension=args.embedding_dim,
        layer_count=args.layer_count,
        layer_size=args.layer_size,
        steps=args.steps,
    )
    analyse_model(model.params, "nif", sample_count=args.size * args.size)

    assets_dir = os.path.join(args.out, "assets.extra")
    save_nif_assets(model, meta, assets_dir)
    print(f"# Saved NIF assets to {assets_dir}")

    recon = model.reconstruct_image(img.shape[0], img.shape[1])[..., ::-1]
    write_image(os.path.join(args.out, "nif_reconstruction.exr"), recon)
    err = np.abs(recon - img).mean() / max(img.mean(), 1e-6)
    print(f"# Reconstruction relative L1: {err:.4f}")

    env_fn, env_params = load_nif_env(assets_dir)
    scene = make_primitive_scene()
    arrays, params, _ = build_scene(
        scene, image_width=args.size, image_height=args.size,
        samples_per_pixel=args.spp, max_path_length=6,
    )
    out = render(
        arrays, params, mode="path-trace",
        chunk_size=min(args.size * args.size, 1 << 16),
        env_fn=env_fn, env_params=env_params,
    )
    path = os.path.join(args.out, "spheres_nif.exr")
    write_image(path, out.rgb)
    print(f"# Rendered {path}: mean {out.rgb.mean():.4f}, max {out.rgb.max():.2f}")


if __name__ == "__main__":
    main()
