"""Mesh import: PLY / OBJ / WRL (VRML2) / binary FBX -> triangle soup.

Dependency-free replacement for the reference's assimp pipeline
(``model.h:28-59`` + ``geometry.h:24-79``): pure-Python readers produce a
:class:`TriMesh` triangle soup (positions and optional per-corner uv/normals)
that the scene builder bakes straight into world-space SoA buffers.

Semantics matched to the reference:

* per-corner uv/normal attributes (``geometry.h:61-77``), expanded at load;
* ``flip_uvs`` = assimp ``aiProcess_FlipUVs`` (v -> 1 - v);
* ``flip_winding`` = ``aiProcess_FlipWindingOrder`` (reverse corner order);
* FBX node transforms are ignored — the reference reads ``aiMesh`` vertex
  buffers without applying the node hierarchy;
* meshes without stored normals shade flat (the reference's PLY path leaves
  ``normals_`` unfilled, ``geometry.h:36-50``; we derive the geometric
  normal instead of reading uninitialized memory).

Deliberately NOT reproduced: the first-mesh-only truncation of
``model.h:90,101`` — all meshes of a multi-mesh file are merged.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import NamedTuple

import numpy as np


class TriMesh(NamedTuple):
    """Triangle soup; per-corner attributes (may be None)."""
    positions: np.ndarray          # (T, 3, 3) float32
    uvs: np.ndarray | None         # (T, 3, 2) float32 or None
    normals: np.ndarray | None     # (T, 3, 3) float32 or None

    @property
    def n_tris(self) -> int:
        return len(self.positions)

    def transformed(self, scale=(1.0, 1.0, 1.0), rotate=None,
                    translate=(0.0, 0.0, 0.0), flip_winding=False,
                    flip_uvs=False) -> "TriMesh":
        """Bake scale -> rotate -> translate (the reference's
        ``translate(rotate_y(bvh_node(model)))`` wrapping with load-time
        scale, ``geometry.h:67`` + ``Raytracing_n.cpp:642``)."""
        p = self.positions * np.asarray(scale, np.float32)
        if rotate is not None:
            r = np.asarray(rotate, np.float32)
            p = p @ r.T
        p = p + np.asarray(translate, np.float32)
        n = self.normals
        if n is not None and rotate is not None:
            n = n @ np.asarray(rotate, np.float32).T
        uv = self.uvs
        if flip_uvs and uv is not None:
            uv = np.stack([uv[..., 0], 1.0 - uv[..., 1]], axis=-1)
        if flip_winding:
            p = p[:, ::-1]
            n = None if n is None else n[:, ::-1]
            uv = None if uv is None else uv[:, ::-1]
        return TriMesh(np.ascontiguousarray(p, np.float32),
                       None if uv is None else np.ascontiguousarray(uv, np.float32),
                       None if n is None else np.ascontiguousarray(n, np.float32))


def _soup_from_indexed(verts, faces, uvs=None, normals=None) -> TriMesh:
    """Expand indexed (V,3)+(F,3) data to per-corner soup."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    p = v[f]
    uv = None if uvs is None else np.asarray(uvs, np.float32)[:, :2][f]
    n = None if normals is None else np.asarray(normals, np.float32)[f]
    return TriMesh(p, uv, n)


def _triangulate_polys(polys: list[list[int]]) -> np.ndarray:
    """Fan-triangulate polygon index lists -> (F, 3) int64 (what
    aiProcess_Triangulate does for convex polygons)."""
    tris = []
    for poly in polys:
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    return np.asarray(tris, np.int64).reshape(-1, 3)


def load_mesh(path: str, first_mesh_only: bool = False) -> TriMesh:
    """Dispatch on extension (the reference leaves this to assimp).

    ``first_mesh_only`` reproduces the reference's mesh-0-only truncation
    (``model.h:90,101``) — off by default (it is a bug), but needed for
    apples-to-apples comparisons against the reference's golden renders,
    whose soldier is missing its gun because of it.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path)
    if ext == ".obj":
        return load_obj(path)
    if ext == ".wrl":
        return load_wrl(path)
    if ext == ".fbx":
        return load_fbx(path, first_mesh_only=first_mesh_only)
    raise ValueError(f"unsupported mesh format: {path}")


# --------------------------------------------------------------------- PLY
_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriMesh:
    """PLY reader (ascii + binary little/big endian), arbitrary vertex
    properties (the bunny has x,y,z,confidence,intensity)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    header_end = data.index(b"end_header")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) | ("list", idx_t, cnt_t, name)])
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", _PLY_TYPES[t[2]],
                                        _PLY_TYPES[t[3]], t[4]))
            else:
                elements[-1][2].append((t[-1], _PLY_TYPES[t[1]]))

    verts = faces = uvs = normals = None
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.asarray(tokens[pos:pos + count * width],
                                 np.float32).reshape(count, width)
                pos += count * width
                names = [p[0] for p in props]
                verts = arr[:, [names.index("x"), names.index("y"),
                                names.index("z")]]
                if "nx" in names:
                    normals = arr[:, [names.index("nx"), names.index("ny"),
                                      names.index("nz")]]
                if "u" in names or "s" in names:
                    un = "u" if "u" in names else "s"
                    vn = "v" if "v" in names else "t"
                    uvs = arr[:, [names.index(un), names.index(vn)]]
            elif name == "face":
                polys = []
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    polys.append([int(x) for x in tokens[pos:pos + k]])
                    pos += k
                faces = _triangulate_polys(polys)
            else:
                # skip unknown ascii element (scalar props only)
                pos += count * len(props)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 -1).astype(np.float32)
                fields = arr.dtype.names
                if "nx" in fields:
                    normals = np.stack([arr["nx"], arr["ny"], arr["nz"]],
                                       -1).astype(np.float32)
                if "u" in fields:
                    uvs = np.stack([arr["u"], arr["v"]], -1).astype(np.float32)
            elif name == "face":
                # variable-length lists: walk record by record
                assert props[0][0] == "list"
                cnt_t = np.dtype(endian + props[0][1])
                idx_t = np.dtype(endian + props[0][2])
                polys = []
                for _ in range(count):
                    k = int(np.frombuffer(body, cnt_t, 1, off)[0])
                    off += cnt_t.itemsize
                    polys.append(np.frombuffer(body, idx_t, k, off).tolist())
                    off += idx_t.itemsize * k
                faces = _triangulate_polys(polys)
    if verts is None or faces is None:
        raise ValueError(f"{path}: no vertex/face elements")
    return _soup_from_indexed(verts, faces, uvs, normals)


# --------------------------------------------------------------------- OBJ
def load_obj(path: str) -> TriMesh:
    """Wavefront OBJ with v/vt/vn and polygonal f records."""
    vs, vts, vns = [], [], []
    corners = []  # list of polygons, each a list of (vi, ti, ni)
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                vts.append([float(x) for x in t[1:3]])
            elif t[0] == "vn":
                vns.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                poly = []
                for w in t[1:]:
                    parts = (w.split("/") + ["", ""])[:3]
                    vi = int(parts[0])
                    ti = int(parts[1]) if parts[1] else 0
                    ni = int(parts[2]) if parts[2] else 0
                    poly.append((vi, ti, ni))
                corners.append(poly)
    v = np.asarray(vs, np.float32)
    vt = np.asarray(vts, np.float32) if vts else None
    vn = np.asarray(vns, np.float32) if vns else None

    def resolve(i, n):  # OBJ 1-based, negative = relative
        return i - 1 if i > 0 else n + i

    pos, uv, nrm = [], [], []
    has_uv = vt is not None and any(c[1] != 0 for poly in corners for c in poly)
    has_n = vn is not None and any(c[2] != 0 for poly in corners for c in poly)
    for poly in corners:
        for k in range(1, len(poly) - 1):
            tri = (poly[0], poly[k], poly[k + 1])
            pos.append([v[resolve(c[0], len(v))] for c in tri])
            if has_uv:
                uv.append([vt[resolve(c[1], len(vt))][:2] if c[1] else (0, 0)
                           for c in tri])
            if has_n:
                nrm.append([vn[resolve(c[2], len(vn))] if c[2] else (0, 0, 1)
                            for c in tri])
    return TriMesh(np.asarray(pos, np.float32),
                   np.asarray(uv, np.float32) if has_uv else None,
                   np.asarray(nrm, np.float32) if has_n else None)


# --------------------------------------------------------------------- WRL
def load_wrl(path: str) -> TriMesh:
    """Minimal VRML 2.0 reader: every IndexedFaceSet's Coordinate points +
    coordIndex (enough for ``contents/models/bunny.wrl``)."""
    with open(path, "r", errors="replace") as f:
        text = f.read()

    import re

    def brackets(src: str, key: str) -> list[str]:
        """Contents of every ``key [ ... ]`` block (whole-word key)."""
        out = []
        for m in re.finditer(r"(?<![A-Za-z_])" + key + r"\s*\[", src):
            depth, k = 1, m.end()
            while depth:
                if src[k] == "[":
                    depth += 1
                elif src[k] == "]":
                    depth -= 1
                k += 1
            out.append(src[m.end():k - 1])
        return out

    all_pos = []
    points = brackets(text, "point")
    indices = brackets(text, "coordIndex")
    for pts, idx in zip(points, indices):
        coords = np.asarray(pts.replace(",", " ").split(), np.float32)
        coords = coords.reshape(-1, 3)
        polys, cur = [], []
        for i in np.asarray(idx.replace(",", " ").split(), np.int64):
            if i < 0:
                if len(cur) >= 3:
                    polys.append(cur)
                cur = []
            else:
                cur.append(int(i))
        if len(cur) >= 3:
            polys.append(cur)
        faces = _triangulate_polys(polys)
        all_pos.append(coords[faces])
    if not all_pos:
        raise ValueError(f"{path}: no IndexedFaceSet found")
    return TriMesh(np.concatenate(all_pos), None, None)


# --------------------------------------------------------------------- FBX
class _FbxNode(NamedTuple):
    name: str
    props: list
    children: list


def _parse_fbx(data: bytes) -> tuple[list[_FbxNode], int]:
    if not data.startswith(b"Kaydara FBX Binary"):
        raise ValueError("only binary FBX supported (ASCII FBX not found "
                         "in the reference assets)")
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500  # 7.5+ widens offsets to 64-bit
    word = "<QQQ" if big else "<III"
    wlen = 25 if big else 13
    f = io.BytesIO(data)
    f.seek(27)

    def read_props(n):
        out = []
        for _ in range(n):
            code = f.read(1)
            if code == b"Y":
                out.append(struct.unpack("<h", f.read(2))[0])
            elif code == b"C":
                out.append(bool(f.read(1)[0]))
            elif code == b"I":
                out.append(struct.unpack("<i", f.read(4))[0])
            elif code == b"F":
                out.append(struct.unpack("<f", f.read(4))[0])
            elif code == b"D":
                out.append(struct.unpack("<d", f.read(8))[0])
            elif code == b"L":
                out.append(struct.unpack("<q", f.read(8))[0])
            elif code in (b"f", b"d", b"l", b"i", b"b"):
                n_el, enc, comp = struct.unpack("<III", f.read(12))
                raw = f.read(comp)
                if enc == 1:
                    raw = zlib.decompress(raw)
                dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4",
                      b"b": "u1"}[code]
                out.append(np.frombuffer(raw, dt, n_el))
            elif code == b"S":
                n_b = struct.unpack("<I", f.read(4))[0]
                out.append(f.read(n_b).decode("utf-8", "replace"))
            elif code == b"R":
                n_b = struct.unpack("<I", f.read(4))[0]
                out.append(f.read(n_b))
            else:
                raise ValueError(f"unknown FBX property code {code!r}")
        return out

    def read_node():
        pos = f.tell()
        hdr = f.read(wlen - 1)
        if len(hdr) < wlen - 1:
            return None
        end, n_props, _plen = struct.unpack(word, hdr)
        name_len = f.read(1)[0]
        if end == 0:  # null record
            return None
        name = f.read(name_len).decode("ascii", "replace")
        props = read_props(n_props)
        children = []
        while f.tell() < end:
            child = read_node()
            if child is None:
                break
            children.append(child)
        f.seek(end)
        return _FbxNode(name, props, children)

    roots = []
    while True:
        node = read_node()
        if node is None:
            break
        roots.append(node)
    return roots, version


def _fbx_find(nodes, name):
    return [n for n in nodes if n.name == name]


def _fbx_child_prop(node, name, default=None):
    for c in node.children:
        if c.name == name and c.props:
            return c.props[0]
    return default


def _fbx_layer(geo, layer_name, value_name, index_name, n_corners, width):
    """Resolve a per-polygon-vertex layer (normals/uvs) to (n_corners, width)."""
    layers = _fbx_find(geo.children, layer_name)
    if not layers:
        return None
    layer = layers[0]
    values = _fbx_child_prop(layer, value_name)
    if values is None:
        return None
    values = np.asarray(values, np.float64).reshape(-1, width)
    mapping = _fbx_child_prop(layer, "MappingInformationType", "")
    ref = _fbx_child_prop(layer, "ReferenceInformationType", "Direct")
    if ref == "IndexToDirect":
        idx = _fbx_child_prop(layer, index_name)
        if idx is not None:
            values = values[np.asarray(idx, np.int64)]
    if mapping == "ByPolygonVertex":
        return values[:n_corners].astype(np.float32)
    if mapping == "AllSame":
        return np.broadcast_to(values[0], (n_corners, width)).astype(np.float32)
    return None  # ByVertex etc. resolved by the caller


def load_fbx(path: str, first_mesh_only: bool = False) -> TriMesh:
    """Binary FBX (7.x) geometry reader, all meshes merged
    (fixing the reference's mesh-0-only bug, ``model.h:90,101``;
    ``first_mesh_only`` opts back into it for golden parity)."""
    with open(path, "rb") as f:
        roots, _version = _parse_fbx(f.read())
    objects = _fbx_find(roots, "Objects")
    if not objects:
        raise ValueError(f"{path}: no Objects section")
    pos_all, uv_all, n_all = [], [], []
    for geo in _fbx_find(objects[0].children, "Geometry"):
        verts = _fbx_child_prop(geo, "Vertices")
        pvi = _fbx_child_prop(geo, "PolygonVertexIndex")
        if verts is None or pvi is None:
            continue
        verts = np.asarray(verts, np.float64).reshape(-1, 3)
        pvi = np.asarray(pvi, np.int64)

        # Polygon corners: negative entry = ~(last index of polygon).
        corner_vi = np.where(pvi < 0, ~pvi, pvi)
        n_corners = len(pvi)

        # Per-corner layers (most common: Normals ByPolygonVertex Direct,
        # UV ByPolygonVertex IndexToDirect).
        nrm = _fbx_layer(geo, "LayerElementNormal", "Normals",
                         "NormalsIndex", n_corners, 3)
        uv = _fbx_layer(geo, "LayerElementUV", "UV", "UVIndex", n_corners, 2)

        # Fan-triangulate each polygon in corner space.
        poly_starts = np.concatenate([[0], np.nonzero(pvi < 0)[0] + 1])
        tri_corners = []
        for s, e in zip(poly_starts[:-1], poly_starts[1:]):
            for k in range(s + 1, e - 1):
                tri_corners.append((s, k, k + 1))
        tri_corners = np.asarray(tri_corners, np.int64)
        if len(tri_corners) == 0:
            continue
        pos_all.append(verts[corner_vi[tri_corners]].astype(np.float32))
        uv_all.append(None if uv is None else uv[tri_corners])
        n_all.append(None if nrm is None else nrm[tri_corners])
    if not pos_all:
        raise ValueError(f"{path}: no polygon geometry found")
    if first_mesh_only:
        pos_all, uv_all, n_all = pos_all[:1], uv_all[:1], n_all[:1]
    pos = np.concatenate(pos_all)
    uv = (np.concatenate([u for u in uv_all])
          if all(u is not None for u in uv_all) else None)
    nrm = (np.concatenate([n for n in n_all])
           if all(n is not None for n in n_all) else None)
    return TriMesh(pos, uv, nrm)
