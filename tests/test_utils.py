"""Utility-layer tests: EXR codec round-trip, image MSE, GLB loading,
camera math, crop parsing."""

import numpy as np
import pytest


def test_exr_round_trip(tmp_path):
    from ipu_ray_lib_tpu.utils.exr import read_exr, write_exr

    rng = np.random.default_rng(0)
    img = rng.normal(0, 10, (17, 23, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    write_exr(p, img)
    back = read_exr(p)
    np.testing.assert_array_equal(img, back)


def test_write_image_dispatch(tmp_path):
    from ipu_ray_lib_tpu.utils.image import read_image, write_image

    img = np.random.default_rng(1).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    p = str(tmp_path / "x.exr")
    write_image(p, img)
    np.testing.assert_allclose(read_image(p), img)


def test_glb_monkey_loads():
    from ipu_ray_lib_tpu.scene.gltf import load_glb_meshes

    meshes = load_glb_meshes("assets/monkey_bust.glb")
    assert len(meshes) == 2
    total_tris = sum(len(m.triangles) for m in meshes)
    assert total_tris == 64 + 3936  # plinth cylinder + Suzanne
    for m in meshes:
        assert np.all(m.triangles < len(m.vertices))
        lo, hi = m.bounds()
        assert np.all(hi >= lo)


def test_cornell_with_monkey_builds():
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene

    scene = make_cornell_box_scene("assets/monkey_bust.glb", box_only=False)
    arrays, params, bvh = build_scene(scene, image_width=32, image_height=32)
    assert params.num_geoms == 11
    # ~4k triangles + box quads + prims:
    leaves = (np.asarray(arrays.bvh_geom) != 0xFFFF).sum()
    assert leaves > 4000


def test_pixel_to_ray_dir_center():
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.ops.camera import pixel_to_ray_dir

    d = np.asarray(
        pixel_to_ray_dir(
            jnp.float32(50.0), jnp.float32(50.0), 100.0, 100.0, jnp.float32(0.5)
        )
    )
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-6)
    # Off-centre x: positive column -> +x direction
    d = np.asarray(
        pixel_to_ray_dir(
            jnp.float32(100.0), jnp.float32(50.0), 100.0, 100.0, jnp.float32(0.5)
        )
    )
    assert d[0] > 0 and abs(d[1]) < 1e-6


def test_crop_parsing():
    import trace as trace_cli

    win = trace_cli.parse_crop("100x50+10+20")
    assert (win.w, win.h, win.c, win.r) == (100, 50, 10, 20)
    assert trace_cli.parse_crop("") is None
    with pytest.raises(ValueError):
        trace_cli.parse_crop("bad")


def test_material_heuristics():
    from ipu_ray_lib_tpu.scene.io import interpret_material
    from ipu_ray_lib_tpu.scene.types import MaterialType

    m = interpret_material("plain", diffuse=[0.5, 0.5, 0.5])
    assert m.type == MaterialType.DIFFUSE

    m = interpret_material("winGLASS pane", diffuse=[1, 1, 1])
    assert m.type == MaterialType.REFRACTIVE

    m = interpret_material("mirror", diffuse=[1, 1, 1], reflectivity=0.9)
    assert m.type == MaterialType.SPECULAR

    m = interpret_material("lamp", diffuse=[1, 1, 1], emissive=[1, 0.5, 0.2],
                           shininess=10.0)
    assert m.emissive
    np.testing.assert_allclose(m.emission, [10, 5, 2])


def test_obj_import(tmp_path):
    """OBJ + MTL import: geometry, grouping by material, heuristics."""
    import numpy as np

    mtl = tmp_path / "scene.mtl"
    mtl.write_text(
        "newmtl red\nKd 0.8 0.1 0.1\n"
        "newmtl lamp\nKd 0.7 0.7 0.7\nKe 1 1 1\nNs 20\n"
        "newmtl glass_thing\nKd 0.9 0.9 0.9\nNi 1.45\nd 0.2\n"
        "newmtl mirror\nKd 1 1 1\nillum 5\n"
    )
    obj = tmp_path / "scene.obj"
    obj.write_text(
        "mtllib scene.mtl\n"
        "v 0 0 -5\nv 1 0 -5\nv 1 1 -5\nv 0 1 -5\n"
        "vn 0 0 1\n"
        "usemtl red\nf 1//1 2//1 3//1 4//1\n"     # quad -> 2 tris
        "usemtl lamp\nf -4 -3 -2\n"                # relative indices
        "usemtl glass_thing\nf 1 2 3\n"
        "usemtl mirror\nf 1 3 4\n"
    )
    from ipu_ray_lib_tpu.scene.io import import_scene
    from ipu_ray_lib_tpu.scene.types import MaterialType

    scene = import_scene(str(obj), load_normals=True)
    assert len(scene.meshes) == 4
    assert len(scene.meshes[0].triangles) == 2    # fan-triangulated quad
    assert scene.meshes[0].has_normals
    mats = scene.materials
    assert np.allclose(mats[0].albedo, [0.8, 0.1, 0.1])
    assert mats[1].emissive and np.allclose(mats[1].emission, [20, 20, 20])
    assert mats[2].type == MaterialType.REFRACTIVE
    assert abs(mats[2].ior - 1.45) < 1e-6
    assert mats[3].type == MaterialType.SPECULAR

    # And the imported scene actually builds + renders:
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    assert out.hit_count > 0


def test_ply_import(tmp_path):
    """PLY import: ASCII and binary little-endian, quads fan-triangulated."""
    import struct

    import numpy as np

    ascii_ply = tmp_path / "quad.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\ncomment a quad\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 -5 0 0 1\n1 0 -5 0 0 1\n1 1 -5 0 0 1\n0 1 -5 0 0 1\n"
        "4 0 1 2 3\n"
    )
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(ascii_ply), load_normals=True)
    assert len(scene.meshes) == 1
    assert len(scene.meshes[0].triangles) == 2
    assert scene.meshes[0].has_normals

    bin_ply = tmp_path / "tri.ply"
    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 3\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    verts = np.asarray([[0, 0, -5], [1, 0, -5], [0, 1, -5]], "<f4")
    face = struct.pack("<B3i", 3, 0, 1, 2)
    bin_ply.write_bytes(header + verts.tobytes() + face)
    scene2 = import_scene(str(bin_ply))
    assert len(scene2.meshes[0].triangles) == 1
    np.testing.assert_allclose(scene2.meshes[0].vertices, verts)

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    assert out.hit_count > 0


def test_stl_import(tmp_path):
    """STL import: binary with vertex welding, and ASCII."""
    import struct

    import numpy as np

    tri1 = [[0, 0, -5], [1, 0, -5], [1, 1, -5]]
    tri2 = [[0, 0, -5], [1, 1, -5], [0, 1, -5]]   # shares an edge
    rec = b""
    for tri in (tri1, tri2):
        rec += struct.pack("<3f", 0, 0, 1)
        for v in tri:
            rec += struct.pack("<3f", *v)
        rec += struct.pack("<H", 0)
    stl = tmp_path / "mesh.stl"
    stl.write_bytes(b"\x00" * 80 + struct.pack("<I", 2) + rec)

    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(stl))
    assert len(scene.meshes[0].triangles) == 2
    assert len(scene.meshes[0].vertices) == 4     # welded shared edge

    ascii_stl = tmp_path / "mesh_a.stl"
    ascii_stl.write_text(
        "solid a\nfacet normal 0 0 1\nouter loop\n"
        "vertex 0 0 -5\nvertex 1 0 -5\nvertex 1 1 -5\n"
        "endloop\nendfacet\nendsolid a\n"
    )
    scene2 = import_scene(str(ascii_stl))
    assert len(scene2.meshes[0].triangles) == 1

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    assert out.hit_count > 0


def test_off_import(tmp_path):
    """OFF import: counts header, fan triangulation of a quad face."""
    off = tmp_path / "quad.off"
    off.write_text(
        "OFF\n# a quad and a tri; faces carry trailing colours\n4 2 0\n"
        "0 0 -5\n1 0 -5\n1 1 -5\n0 1 -5\n"
        "4 0 1 2 3 255 0 0\n3 0 2 3 0.2 0.8 0.2 1.0\n"
    )
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(off))
    assert len(scene.meshes[0].triangles) == 3   # 2 (fan) + 1
    assert len(scene.meshes[0].vertices) == 4

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    assert out.hit_count > 0


def _fbx_binary_bytes(version=7400, camera=False):
    """Minimal spec-conforming binary FBX: one quad Geometry
    (zlib-compressed vertex array), a Model with an Lcl Translation, a
    red Material, and OO connections. version >= 7500 switches the
    record headers to the u64 layout (FBX 2016+). camera=True adds a
    'Camera'-typed Model at (2.5, 0.5, 5) with Lcl Rotation (0, 90, 0)
    — FBX cameras aim down local +X, so yaw 90 turns that onto world
    -Z — plus a connected NodeAttribute carrying FieldOfView 10."""
    import struct
    import zlib

    big = version >= 7500

    def S(s):
        b = s.encode()
        return b"S" + struct.pack("<I", len(b)) + b

    def L(v):
        return b"L" + struct.pack("<q", v)

    def D(v):
        return b"D" + struct.pack("<d", v)

    def darr(vals, compress=False):
        import numpy as _np
        raw = _np.asarray(vals, "<f8").tobytes()
        if compress:
            comp = zlib.compress(raw)
            return b"d" + struct.pack("<III", len(vals), 1, len(comp)) + comp
        return b"d" + struct.pack("<III", len(vals), 0, len(raw)) + raw

    def iarr(vals):
        import numpy as _np
        raw = _np.asarray(vals, "<i4").tobytes()
        return b"i" + struct.pack("<III", len(vals), 0, len(raw)) + raw

    def node(name, props, children=()):
        return (name, props, children)

    hdr_fmt, hdr_n, null_n = ("<QQQ", 24, 25) if big else ("<III", 12, 13)

    def ser(n, start):
        name = n[0].encode()
        props = b"".join(n[1])
        header = hdr_n + 1 + len(name)
        pos = start + header + len(props)
        kid_bytes = b""
        if n[2]:
            for k in n[2]:
                kb = ser(k, pos)
                kid_bytes += kb
                pos += len(kb)
            kid_bytes += b"\x00" * null_n
            pos += null_n
        return (struct.pack(hdr_fmt, pos, len(n[1]), len(props))
                + bytes([len(name)]) + name + props + kid_bytes)

    cam_objects = [
        node("Model", [L(400), S("Model::Cam\x00\x01Model"), S("Camera")], [
            node("Properties70", [], [
                node("P", [S("Lcl Translation"), S("Lcl Translation"),
                           S(""), S("A"), D(2.5), D(0.5), D(5.0)]),
                node("P", [S("Lcl Rotation"), S("Lcl Rotation"),
                           S(""), S("A"), D(0.0), D(90.0), D(0.0)]),
            ]),
        ]),
        node("NodeAttribute",
             [L(500), S("NodeAttribute::Cam\x00\x01NodeAttribute"),
              S("Camera")], [
            node("Properties70", [], [
                node("P", [S("FieldOfView"), S("FieldOfView"), S(""),
                           S("A"), D(10.0)]),
            ]),
        ]),
    ] if camera else []
    cam_conns = [node("C", [S("OO"), L(500), L(400)])] if camera else []

    verts = [0, 0, -5, 1, 0, -5, 1, 1, -5, 0, 1, -5]
    tree = [
        node("Objects", [], [
            node("Geometry", [L(100), S("Geometry::Quad\x00\x01Geometry"),
                              S("Mesh")], [
                node("Vertices", [darr(verts, compress=True)]),
                node("PolygonVertexIndex", [iarr([0, 1, 2, -4])]),
            ]),
            node("Model", [L(200), S("Model::Quad\x00\x01Model"),
                           S("Mesh")], [
                node("Properties70", [], [
                    node("P", [S("Lcl Translation"), S("Lcl Translation"),
                               S(""), S("A"), D(2.0), D(0.0), D(-1.0)]),
                ]),
            ]),
            node("Material", [L(300), S("Material::Red\x00\x01Material"),
                              S("")], [
                node("Properties70", [], [
                    node("P", [S("DiffuseColor"), S("Color"), S(""),
                               S("A"), D(0.8), D(0.1), D(0.1)]),
                ]),
            ]),
        ] + cam_objects),
        node("Connections", [], [
            node("C", [S("OO"), L(100), L(200)]),
            node("C", [S("OO"), L(300), L(200)]),
        ] + cam_conns),
    ]
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + __import__("struct").pack(
        "<I", version)
    pos = len(out)
    for n in tree:
        b = ser(n, pos)
        out += b
        pos += len(b)
    out += b"\x00" * null_n
    return out


import pytest


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_import_binary(tmp_path, version):
    """Binary FBX: node records (u32 pre-7500, u64 from FBX 2016's
    7500), zlib arrays, polygon fan triangulation, material +
    connection wiring (the assimp-breadth FBX gap,
    ref scene_utils.cpp:152-176)."""
    import numpy as np

    fbx = tmp_path / "quad.fbx"
    fbx.write_bytes(_fbx_binary_bytes(version))
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(fbx))
    assert len(scene.meshes) == 1            # Geometry bound via its Model,
    mesh = scene.meshes[0]                   # not duplicated as an orphan
    assert len(mesh.triangles) == 2          # quad -> 2 tris
    assert len(mesh.vertices) == 4
    # The Model's Lcl Translation (2, 0, -1) must apply (a 7.x Model is
    # typed "Mesh" but carries no geometry; it must register as the
    # transform/material carrier):
    np.testing.assert_allclose(mesh.vertices[0], [2.0, 0.0, -6.0])
    np.testing.assert_allclose(scene.materials[scene.mat_ids[0]].albedo,
                               [0.8, 0.1, 0.1])

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    assert out.hit_count > 0


@pytest.mark.parametrize("version", [7400, 7500])
def test_fbx_camera_import_binary(tmp_path, version):
    """FBX camera import (ref scene_utils.cpp:177-207:
    assimp reads cameras from every format it parses). The
    Camera-typed Model's Lcl Translation/Rotation and its connected
    NodeAttribute's FieldOfView must drive the render window: camera at
    (2.5, 0.5, 5) with yaw 90 (FBX cameras aim down local +X; 90 turns
    that onto world -Z) and fov 10 deg puts the quad (world z=-6,
    x 2-3, y 0-1) dead centre, spanning ~half the frame."""
    import numpy as np

    fbx = tmp_path / "cam.fbx"
    fbx.write_bytes(_fbx_binary_bytes(version, camera=True))
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(fbx))
    np.testing.assert_allclose(scene.camera.horizontal_fov,
                               np.deg2rad(10.0), rtol=1e-6)
    # Camera-space check: yaw-90 ∘ (FBX +X-forward basis) is exactly the
    # renderer's identity orientation, so camera space = world - t:
    centroid = scene.meshes[0].vertices.mean(axis=0)
    np.testing.assert_allclose(centroid, [0.0, 0.0, -11.0], atol=1e-5)

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene

    arrays, params, _ = build_scene(scene, image_width=16, image_height=16,
                                    samples_per_pixel=1, intersector="dense")
    out = render(arrays, params, mode="shadow-trace", chunk_size=256)
    ids = np.asarray(out.geom_id).reshape(16, 16)
    assert ids[8, 8] >= 0, "imported camera pose must centre the quad"
    assert out.hit_count > 0


def test_fbx_camera_import_ascii(tmp_path):
    """ASCII form of the camera import, with FieldOfView carried on the
    camera Model's own Properties70 (no NodeAttribute — both property
    homes exist in the wild)."""
    import numpy as np

    fbx = tmp_path / "cam_ascii.fbx"
    fbx.write_text(
        'Objects:  {\n'
        '\tGeometry: 100, "Geometry::Quad", "Mesh" {\n'
        '\t\tVertices: *12 {\n'
        '\t\t\ta: 0,0,-5,1,0,-5,1,1,-5,0,1,-5\n'
        '\t\t}\n'
        '\t\tPolygonVertexIndex: *4 {\n'
        '\t\t\ta: 0,1,2,-4\n'
        '\t\t}\n'
        '\t}\n'
        '\tModel: 200, "Model::Quad", "Mesh" {\n'
        '\t}\n'
        '\tModel: 400, "Model::Cam", "Camera" {\n'
        '\t\tProperties70:  {\n'
        '\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",0.5,0.5,5.0\n'
        '\t\t\tP: "Lcl Rotation", "Lcl Rotation", "", "A",0.0,90.0,0.0\n'
        '\t\t\tP: "FieldOfView", "FieldOfView", "", "A",10.0\n'
        '\t\t}\n'
        '\t}\n'
        '}\n'
        'Connections:  {\n'
        '\tC: "OO",100,200\n'
        '}\n'
    )
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(fbx))
    np.testing.assert_allclose(scene.camera.horizontal_fov,
                               np.deg2rad(10.0), rtol=1e-6)
    centroid = scene.meshes[0].vertices.mean(axis=0)
    np.testing.assert_allclose(centroid, [0.0, 0.0, -10.0], atol=1e-5)


def test_fbx_import_ascii(tmp_path):
    """ASCII FBX: brace tree, *N arrays with a: continuation lines."""
    fbx = tmp_path / "quad_ascii.fbx"
    fbx.write_text(
        '; FBX 7.4.0 project file\n'
        'Objects:  {\n'
        '\tGeometry: 100, "Geometry::Quad", "Mesh" {\n'
        '\t\tVertices: *12 {\n'
        '\t\t\ta: 0,0,-5,1,0,-5,1,1,\n'
        '\t\t\t-5,0,1,-5\n'
        '\t\t}\n'
        '\t\tPolygonVertexIndex: *4 {\n'
        '\t\t\ta: 0,1,2,-4\n'
        '\t\t}\n'
        '\t}\n'
        '\tModel: 200, "Model::Quad", "Mesh" {\n'
        '\t}\n'
        '\tMaterial: 300, "Material::Green", "" {\n'
        '\t\tProperties70:  {\n'
        '\t\t\tP: "DiffuseColor", "Color", "", "A",0.1,0.9,0.2\n'
        '\t\t}\n'
        '\t}\n'
        '}\n'
        'Connections:  {\n'
        '\tC: "OO",100,200\n'
        '\tC: "OO",300,200\n'
        '}\n'
    )
    import numpy as np

    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(fbx))
    assert len(scene.meshes[0].triangles) == 2
    np.testing.assert_allclose(scene.materials[scene.mat_ids[0]].albedo,
                               [0.1, 0.9, 0.2])


def test_fbx_import_ascii_v6_value_list(tmp_path):
    """FBX 6.x-style geometry: a 'Mesh'-typed Model node carrying
    Vertices/PolygonVertexIndex directly as plain value lists (no *N/a:
    wrapper) — the legacy exporter format."""
    fbx = tmp_path / "six.fbx"
    fbx.write_text(
        'Objects:  {\n'
        '\tModel: "Model::Quad", "Mesh" {\n'
        '\t\tVertices: 0,0,-5,1,0,-5,1,1,-5,0,1,-5\n'
        '\t\tPolygonVertexIndex: 0,1,2,-4\n'
        '\t}\n'
        '}\n'
    )
    from ipu_ray_lib_tpu.scene.io import import_scene

    scene = import_scene(str(fbx))
    assert len(scene.meshes) == 1
    assert len(scene.meshes[0].triangles) == 2
    assert len(scene.meshes[0].vertices) == 4


def test_cli_scene_cache_invalidates_on_mesh_edit(tmp_path):
    """--scene-cache keys mesh files by (path, mtime, size): editing the
    scene file must MISS the cache, not silently load stale geometry."""
    import os as _os
    import sys as _sys

    _sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
    import trace as cli

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 -5\nv 1 0 -5\nv 1 1 -5\nf 1 2 3\n")
    cache = str(tmp_path / "cache")
    args = ["--mesh-file", str(obj), "-w", "8", "-H", "8",
            "--render-mode", "shadow-trace", "--visualise", "id",
            "--chunk-size", "64", "--device-only", "--intersector", "dense",
            "--scene-cache", cache,
            "-o", str(tmp_path / "o1"), "--log-level", "warn"]
    assert cli.main(args) == 0
    assert len(_os.listdir(cache)) == 1
    # Edit the mesh (different size => different key even if mtime
    # granularity is coarse):
    obj.write_text("v 0 0 -5\nv 2 0 -5\nv 2 2 -5\nv 0 2 -5\n"
                   "f 1 2 3\nf 1 3 4\n")
    args[-3] = str(tmp_path / "o2")
    assert cli.main(args) == 0
    assert len(_os.listdir(cache)) == 2   # second bundle, not a stale hit
