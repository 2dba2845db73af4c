"""FBX scene import (binary and ASCII), self-contained.

Covers the reference's assimp FBX import (ref:
src/scene_utils.cpp:152-176 — assimp reads FBX): a minimal, dependency-
free reader of the Kaydara FBX format covering what the renderer needs —
mesh geometry (Vertices + PolygonVertexIndex with fan triangulation of
n-gons), per-model local transforms (Lcl Translation / RotationXYZ
degrees / Scaling), materials (DiffuseColor / EmissiveColor /
TransparencyFactor / ReflectionFactor via the shared
``interpret_material`` heuristics), and Geometry/Material->Model
connections. Binary records follow the published node layout (u32
offsets, u64 from version 7500; zlib-compressed typed arrays); ASCII
files parse as the brace-structured node tree with ``a:`` continuation
lines.

Cameras import from 'Camera'-typed Model nodes (as the reference's
importer does, src/scene_utils.cpp:177-207): Lcl Translation /
Rotation give the camera's world pose, FieldOfView (degrees, from the
Model's own properties or its connected NodeAttribute) the horizontal
FOV, and the scene is transformed into camera space exactly as the
glTF/Collada importers do. FBX cameras natively aim down their local
+X axis with +Y up (Maya convention); the importer rebases that onto
the renderer's -Z-forward convention. Only a genuinely camera-free
file falls back to the origin looking down -z with a warning.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils.log import logger
from .io import _to_camera_space, interpret_material
from .types import Camera, HostMesh, Material, SceneDescription

_MAGIC = b"Kaydara FBX Binary  \x00"


# ---------------------------------------------------------------------------
# Binary node tree
# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_props(buf, pos, count):
    props = []
    for _ in range(count):
        t = buf[pos:pos + 1]
        pos += 1
        if t == b"Y":
            props.append(struct.unpack_from("<h", buf, pos)[0]); pos += 2
        elif t == b"C":
            props.append(bool(buf[pos])); pos += 1
        elif t == b"I":
            props.append(struct.unpack_from("<i", buf, pos)[0]); pos += 4
        elif t == b"F":
            props.append(struct.unpack_from("<f", buf, pos)[0]); pos += 4
        elif t == b"D":
            props.append(struct.unpack_from("<d", buf, pos)[0]); pos += 8
        elif t == b"L":
            props.append(struct.unpack_from("<q", buf, pos)[0]); pos += 8
        elif t in (b"f", b"d", b"l", b"i", b"b"):
            n, enc, clen = struct.unpack_from("<III", buf, pos)
            pos += 12
            raw = buf[pos:pos + clen] if enc else None
            dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4",
                  b"b": "u1"}[t]
            width = np.dtype(dt).itemsize
            if enc == 1:
                raw = zlib.decompress(raw)
                pos += clen
            else:
                raw = buf[pos:pos + n * width]
                pos += n * width
            props.append(np.frombuffer(raw, dtype=dt, count=n))
        elif t == b"S" or t == b"R":
            (n,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            props.append(buf[pos:pos + n])
            pos += n
        else:
            raise ValueError(f"FBX: unknown property type {t!r}")
    return props, pos


def _read_node(buf, pos, big):
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    nlen = buf[pos]
    pos += 1
    if end == 0:  # null terminator record
        return None, pos
    name = buf[pos:pos + nlen].decode("ascii", "replace")
    pos += nlen
    props, pos = _read_props(buf, pos, nprops)
    node = _Node(name, props)
    while pos < end:
        child, pos = _read_node(buf, pos, big)
        if child is None:
            break
        node.children.append(child)
    return node, end


def _parse_binary(buf) -> _Node:
    version = struct.unpack_from("<I", buf, len(_MAGIC) + 2)[0]
    big = version >= 7500
    pos = len(_MAGIC) + 2 + 4
    root = _Node("", [])
    while pos < len(buf):
        node, pos = _read_node(buf, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------------------
# ASCII node tree (same _Node shape)
# ---------------------------------------------------------------------------
def _parse_ascii(text: str) -> _Node:
    root = _Node("", [])
    stack = [root]
    pending_vals: list | None = None

    def _vals(s):
        out = []
        for tok in s.split(","):
            tok = tok.strip().strip("}").strip()
            if not tok or tok == "{":
                continue
            if tok.startswith('"'):
                out.append(tok.strip('"'))
            else:
                try:
                    out.append(int(tok))
                except ValueError:
                    try:
                        out.append(float(tok))
                    except ValueError:
                        out.append(tok)
        return out

    for raw in text.splitlines():
        line = raw.split(";")[0].strip()
        if not line:
            continue
        if line == "}":
            stack.pop()
            pending_vals = None
            continue
        if ":" not in line and pending_vals is not None:
            # bare continuation line of an "a:" value list
            pending_vals.extend(_vals(line))
            continue
        if ":" in line:
            name, rest = line.split(":", 1)
            name = name.strip()
            opens = rest.rstrip().endswith("{")
            rest = rest.rstrip().rstrip("{").strip()
            if name == "a" and pending_vals is not None:
                pending_vals.extend(_vals(rest))
                continue
            if rest.startswith("*"):
                # typed array: "*N {" then "a: v,v,..." lines
                node = _Node(name, [])
                stack[-1].children.append(node)
                if opens:
                    stack.append(node)
                    pending_vals = []
                    node.props.append(pending_vals)
                continue
            node = _Node(name, _vals(rest))
            stack[-1].children.append(node)
            if opens:
                stack.append(node)
        elif line.endswith("{"):
            node = _Node(line.rstrip("{").strip(), [])
            stack[-1].children.append(node)
            stack.append(node)
    return root


def _arr(node) -> np.ndarray:
    """Node values as a numpy array. Three storages exist in the wild:
    a typed binary array (one ndarray prop), an ASCII ``*N { a: ... }``
    list (one list prop), and FBX 6.x plain value lists (ASCII
    ``Vertices: 0,0,-5,...`` / binary N scalar props) where every value
    is its own prop."""
    p = node.props[0]
    if isinstance(p, np.ndarray):
        return p
    if isinstance(p, list):
        return np.asarray(p, np.float64)
    return np.asarray(node.props, np.float64)


# ---------------------------------------------------------------------------
# Scene assembly
# ---------------------------------------------------------------------------
def _props70(node):
    out = {}
    p70 = node.first("Properties70") or node.first("Properties60")
    if p70 is None:
        return out
    for p in p70.children:
        if not p.props:
            continue
        key = p.props[0]
        if isinstance(key, bytes):
            key = key.decode("utf-8", "replace")
        vals = [v for v in p.props[1:] if isinstance(v, (int, float))]
        out[key] = vals
    return out


def _euler_xyz(deg):
    rx, ry, rz = np.deg2rad(np.asarray(deg, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _node_type(node) -> str:
    """The FBX object subtype: the LAST string prop of an Objects child
    (binary Model props are [id, "Name\\x00\\x01Model", "Mesh"|"Camera"|..];
    FBX 6.x ASCII drops the id)."""
    t = ""
    for p in node.props:
        if isinstance(p, bytes):
            t = p.split(b"\x00")[0].decode("utf-8", "replace")
        elif isinstance(p, str):
            t = p
    return t


# FBX cameras aim down their local +X axis with +Y up (the Maya
# convention assimp also rebases, ref scene_utils.cpp:177-207 reads the
# converted matrix); the renderer's convention is -Z forward / +Y up.
# Columns = the renderer camera's (right, up, back) axes expressed in
# FBX camera-local coordinates: right=+Z, up=+Y, back=-X (forward -Z
# maps onto FBX forward +X, right-handed):
_FBX_CAM_TO_GL = np.array([[0.0, 0.0, -1.0],
                           [0.0, 1.0, 0.0],
                           [1.0, 0.0, 0.0]])


def _triangulate(pvi: np.ndarray) -> np.ndarray:
    """PolygonVertexIndex -> [T, 3] uint32 fan triangulation. A negative
    entry v marks the polygon's last corner with true index ~v."""
    tris = []
    poly = []
    for v in pvi:
        idx = int(v)
        if idx < 0:
            poly.append(~idx)
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
        else:
            poly.append(idx)
    return np.asarray(tris, np.uint32).reshape(-1, 3)


def import_fbx_scene(filename: str, load_normals: bool = False
                     ) -> SceneDescription:
    log = logger()
    with open(filename, "rb") as fh:
        buf = fh.read()
    if buf.startswith(_MAGIC):
        root = _parse_binary(buf)
    else:
        root = _parse_ascii(buf.decode("utf-8", "replace"))

    objects = root.first("Objects")
    if objects is None:
        raise ValueError(f"FBX '{filename}': no Objects section")
    conns = root.first("Connections")

    # id -> (kind, payload)
    geoms, models, mats = {}, {}, {}
    cam_models, attrs = {}, {}   # Camera-typed Models; NodeAttributes
    for node in objects.children:
        nid = node.props[0] if node.props and isinstance(
            node.props[0], (int, np.integer)) else None
        # Geometry lives on Geometry nodes (FBX 7.x) or directly on
        # 'Mesh'-typed Model nodes (FBX 6.x). A 7.x Model is ALSO typed
        # 'Mesh' but carries no Vertices — it must still register as a
        # Model (transform + material connections), so the discriminator
        # is the presence of geometry children, not the type string:
        vn = node.first("Vertices")
        pn = node.first("PolygonVertexIndex")
        has_geo = vn is not None and pn is not None
        if has_geo and node.name in ("Geometry", "Model"):
            verts = _arr(vn).astype(np.float64).reshape(-1, 3)
            tris = _triangulate(_arr(pn).astype(np.int64))
            key = nid if nid is not None else f"g{len(geoms)}"
            geoms[key] = (verts, tris)
            if node.name == "Model":
                models[key] = {"geom": key, "mats": [],
                               "p70": _props70(node)}
        elif node.name == "Model":
            if _node_type(node) == "Camera":
                key = nid if nid is not None else f"c{len(cam_models)}"
                cam_models[key] = {"p70": _props70(node), "attr": {}}
            else:
                models[nid] = {"geom": None, "mats": [],
                               "p70": _props70(node)}
        elif node.name == "NodeAttribute":
            attrs[nid] = _props70(node)
        elif node.name == "Material":
            mats[nid] = _material_from(node)

    # Connections (OO child -> parent): geometry/material -> model.
    if conns is not None:
        for c in conns.find("C") + conns.find("Connect"):
            vals = [v for v in c.props
                    if isinstance(v, (int, np.integer))]
            if len(vals) < 2:
                continue
            child, parent = vals[0], vals[1]
            if parent in models:
                if child in geoms:
                    models[parent]["geom"] = child
                elif child in mats:
                    models[parent]["mats"].append(child)
            elif parent in cam_models and child in attrs:
                cam_models[parent]["attr"] = attrs[child]

    scene = SceneDescription()
    mat_list = []
    mat_index = {}
    for mid, mat in mats.items():
        mat_index[mid] = len(mat_list)
        mat_list.append(mat)
    if not mat_list:
        mat_list = [Material(np.array([0.75, 0.75, 0.75], np.float32))]

    used = set()
    for info in models.values():
        gid = info["geom"]
        if gid is None or gid not in geoms:
            continue
        used.add(gid)
        verts, tris = geoms[gid]
        p70 = info["p70"]
        rot = _euler_xyz(p70.get("Lcl Rotation", [0, 0, 0])[:3]
                         if len(p70.get("Lcl Rotation", [])) >= 3
                         else [0, 0, 0])
        scale = np.asarray(
            p70.get("Lcl Scaling", [1, 1, 1])[:3]
            if len(p70.get("Lcl Scaling", [])) >= 3 else [1, 1, 1],
            np.float64)
        trans = np.asarray(
            p70.get("Lcl Translation", [0, 0, 0])[:3]
            if len(p70.get("Lcl Translation", [])) >= 3 else [0, 0, 0],
            np.float64)
        v = (verts * scale) @ rot.T + trans
        scene.meshes.append(HostMesh(triangles=tris,
                                     vertices=v.astype(np.float32)))
        mids = info["mats"]
        scene.mat_ids.append(mat_index.get(mids[0], 0) if mids else 0)

    # Orphan geometries (no Model connection — common in minimal files):
    for gid, (verts, tris) in geoms.items():
        if gid in used:
            continue
        scene.meshes.append(HostMesh(triangles=tris,
                                     vertices=verts.astype(np.float32)))
        scene.mat_ids.append(0)

    if not scene.meshes:
        raise ValueError(f"FBX '{filename}': no mesh geometry found")
    scene.materials = mat_list
    cam = next(iter(cam_models.values()), None)
    if cam is not None:
        # Model Lcl properties give the pose; FOV may live on the Model
        # itself or on its connected 'Camera' NodeAttribute:
        p70, a70 = cam["p70"], cam["attr"]
        fov_deg = 45.0
        for key in ("FieldOfView", "FieldOfViewX"):
            v = p70.get(key) or a70.get(key)
            if v:
                fov_deg = float(v[0])
                break
        rot = _euler_xyz(p70.get("Lcl Rotation", [0, 0, 0])[:3]
                         if len(p70.get("Lcl Rotation", [])) >= 3
                         else [0, 0, 0])
        trans = np.asarray(
            p70.get("Lcl Translation", [0, 0, 0])[:3]
            if len(p70.get("Lcl Translation", [])) >= 3 else [0, 0, 0],
            np.float64)
        cam_world = np.eye(4)
        cam_world[:3, :3] = rot @ _FBX_CAM_TO_GL
        cam_world[:3, 3] = trans
        _to_camera_space(scene, cam_world)
        scene.camera = Camera(horizontal_fov=float(np.deg2rad(fov_deg)))
        log.info("FBX camera: position %s, rotation applied, fov %.1f deg",
                 trans.tolist(), fov_deg)
    else:
        log.warning("FBX file carries no camera; assuming origin looking "
                    "down -z (fov 45)")
        scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    scene.validate()
    log.info("Imported %d meshes, %d materials from '%s' (%s)",
             len(scene.meshes), len(scene.materials), filename,
             "binary" if buf.startswith(_MAGIC) else "ascii")
    return scene


def _material_from(node) -> Material:
    p70 = _props70(node)
    name = ""
    for p in node.props:
        if isinstance(p, bytes):
            name = p.split(b"\x00")[0].decode("utf-8", "replace")
            break
        if isinstance(p, str):
            name = p
            break

    def get3(key):
        v = p70.get(key)
        return v[:3] if v and len(v) >= 3 else None

    def get1(key):
        v = p70.get(key)
        return v[0] if v else None

    return interpret_material(
        name,
        diffuse=get3("DiffuseColor"),
        emissive=get3("EmissiveColor"),
        shininess=get1("ShininessExponent"),
        transparency=get1("TransparencyFactor"),
        reflectivity=get1("ReflectionFactor"),
    )
