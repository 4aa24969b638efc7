"""Asset I/O tests: mesh readers (PLY/OBJ/WRL/FBX) and the MERL reader.

Synthetic fixtures are written to tmp_path and round-tripped; the real
reference assets are exercised when the mirrored checkout is present
(they are at ``/root/reference/contents`` in CI).
"""
import numpy as np
import pytest

from srt.io.assets import find_asset
from srt.io.mesh import (TriMesh, load_fbx, load_mesh, load_obj,
                             load_ply, load_wrl)
from srt.io import merl as merl_io


# ------------------------------------------------------------------- PLY
def test_ply_ascii_roundtrip(tmp_path):
    p = tmp_path / "tri.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float32 x\nproperty float32 y\nproperty float32 z\n"
        "property float32 confidence\n"
        "element face 2\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 1\n1 0 0 1\n1 1 0 1\n0 1 0 1\n"
        "3 0 1 2\n3 0 2 3\n")
    m = load_ply(str(p))
    assert m.n_tris == 2
    np.testing.assert_allclose(m.positions[0, 1], [1, 0, 0])
    assert m.uvs is None and m.normals is None


def test_ply_binary_roundtrip(tmp_path):
    import struct
    p = tmp_path / "tri_bin.ply"
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 3\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property float nx\nproperty float ny\nproperty float nz\n"
              b"element face 1\n"
              b"property list uchar int vertex_indices\n"
              b"end_header\n")
    body = b""
    for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]:
        body += struct.pack("<6f", *v, 0, 0, 1)
    body += struct.pack("<B3i", 3, 0, 1, 2)
    p.write_bytes(header + body)
    m = load_ply(str(p))
    assert m.n_tris == 1
    np.testing.assert_allclose(m.normals[0], [[0, 0, 1]] * 3)


def test_ply_quad_triangulation(tmp_path):
    p = tmp_path / "quad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    assert load_ply(str(p)).n_tris == 2  # fan split, like aiProcess_Triangulate


def test_bunny_ply():
    path = find_asset("models/bunny.ply")
    if path is None:
        pytest.skip("reference assets not mounted")
    m = load_ply(path)
    # 69451 faces per the file header; no uvs/normals stored.
    assert m.n_tris == 69451
    assert m.uvs is None and m.normals is None
    ext = m.positions.reshape(-1, 3)
    assert np.isfinite(ext).all()
    assert (ext.max(0) - ext.min(0)).max() < 1.0  # unit-scale scan


# ------------------------------------------------------------------- OBJ
def test_obj_with_uv_and_normals(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\n")
    m = load_obj(str(p))
    assert m.n_tris == 1
    np.testing.assert_allclose(m.uvs[0], [[0, 0], [1, 0], [0, 1]])
    np.testing.assert_allclose(m.normals[0], [[0, 0, 1]] * 3)


def test_obj_negative_indices(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    m = load_obj(str(p))
    np.testing.assert_allclose(m.positions[0, 2], [0, 1, 0])


# ------------------------------------------------------------------- WRL
def test_wrl_minimal(tmp_path):
    p = tmp_path / "t.wrl"
    p.write_text("""#VRML V2.0 utf8
Shape { geometry IndexedFaceSet {
  coord Coordinate { point [ 0 0 0, 1 0 0, 1 1 0, 0 1 0 ] }
  coordIndex [ 0, 1, 2, -1, 0, 2, 3, -1 ]
} }""")
    m = load_wrl(str(p))
    assert m.n_tris == 2


# ------------------------------------------------------------------- FBX
def test_soldier_fbx():
    path = find_asset("models/Soilder.FBX")
    if path is None:
        pytest.skip("reference assets not mounted")
    m = load_fbx(path)
    assert m.n_tris > 1000
    assert m.uvs is not None and m.normals is not None
    assert np.isfinite(m.positions).all()
    assert 0.0 <= m.uvs.min() and m.uvs.max() <= 1.0001
    # stored normals are unit
    ln = np.linalg.norm(m.normals, axis=-1)
    np.testing.assert_allclose(ln, 1.0, atol=1e-3)


def test_load_mesh_dispatch(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert load_mesh(str(p)).n_tris == 1
    with pytest.raises(ValueError):
        load_mesh("mesh.xyz")


# -------------------------------------------------------------- transform
def test_trimesh_transform_winding_uv():
    m = TriMesh(np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32),
                np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32),
                np.asarray([[[0, 0, 1]] * 3], np.float32))
    t = m.transformed(scale=(2, 2, 2), translate=(1, 0, 0),
                      flip_winding=True, flip_uvs=True)
    # winding reversed, scale+translate applied
    np.testing.assert_allclose(t.positions[0, 0], [1, 2, 0])  # was corner 2
    np.testing.assert_allclose(t.uvs[0, 0], [0, 0])           # 1 - 1 = 0


# ------------------------------------------------------------------ MERL
def test_merl_roundtrip_and_lookup(tmp_path):
    import jax.numpy as jnp
    from srt.materials import merl as merl_mat

    n = merl_io.RES_THETA_H * merl_io.RES_THETA_D * merl_io.RES_PHI_D // 2
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.0, 10.0, (3, n))
    path = tmp_path / "synthetic.binary"
    merl_io.write_merl(str(path), raw)
    table = merl_io.read_merl(str(path))
    assert table.shape == (3, n)
    scales = np.asarray(merl_io.CHANNEL_SCALES)[:, None]
    np.testing.assert_allclose(table, raw * scales, rtol=1e-5)

    # retro-reflection wo == wi == z  ->  theta_h = theta_d = phi_d = 0
    # -> flat index 0 in each channel plane (brdf.h:200-208).
    wo = jnp.asarray([[0.0, 0.0, 1.0]])
    val = merl_mat.lookup(jnp.asarray(table)[None], jnp.asarray([0]), wo, wo)
    np.testing.assert_allclose(np.asarray(val)[0], table[:, 0], rtol=1e-5)


def test_merl_bad_dims(tmp_path):
    p = tmp_path / "bad.binary"
    np.asarray([2, 2, 2], np.int32).tofile(str(p))
    with pytest.raises(ValueError):
        merl_io.read_merl(str(p))


def test_fbx_first_mesh_only_parity_option():
    """first_mesh_only reproduces the reference's model.h:90,101 truncation
    (golden-parity knob); default merges all meshes."""
    import os
    fbx = "/root/reference/contents/models/Soilder.FBX"
    if not os.path.exists(fbx):
        import pytest
        pytest.skip("reference FBX not available")
    from srt.io.mesh import load_mesh
    full = load_mesh(fbx)
    first = load_mesh(fbx, first_mesh_only=True)
    assert first.n_tris < full.n_tris
    # Mesh 0 is a prefix of the merged soup.
    import numpy as np
    np.testing.assert_array_equal(full.positions[:first.n_tris],
                                  first.positions)
