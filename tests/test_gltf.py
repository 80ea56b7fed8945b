"""Golden-value tests for the glTF reader.

Mirrors the reference's unit tests (gltf_model_reader.rs:690-855): pixel
permutation widen/narrow/mix, src->dst channel maps, and the textured-cube
golden layout (first vertex floats, first indices, first texel bytes). The
cube is the generated stand-in for BoxTextured.glb
(scene/procedural.write_textured_box_glb); its values are pinned here.
"""
import numpy as np
import pytest

from assets import box_path, box_tangents_path
from tpurt.scene import GltfModelReader, MeshAttributeType, TextureType
from tpurt.scene.gltf import generate_src_to_dst_map, permute_pixels


def test_wide_permute_pixel():
    src = np.arange(6, dtype=np.uint8)
    res = permute_pixels(src, 3, {0: 0, 1: 1, 2: 2}, 4)
    assert res.tolist() == [0, 1, 2, 0, 3, 4, 5, 0]


def test_narrow_permute_pixel():
    src = np.arange(8, dtype=np.uint8)
    res = permute_pixels(src, 4, {0: 0, 1: 1, 2: 2}, 3)
    assert res.tolist() == [0, 1, 2, 4, 5, 6]


def test_mix_and_narrow_permute_pixel():
    src = np.arange(8, dtype=np.uint8)
    res = permute_pixels(src, 4, {0: 2, 1: 0, 2: 1}, 3)
    assert res.tolist() == [1, 2, 0, 5, 6, 4]


def test_mix_and_wide_permute_pixel():
    src = np.arange(6, dtype=np.uint8)
    res = permute_pixels(src, 3, {0: 2, 1: 0, 2: 1}, 4)
    assert res.tolist() == [1, 2, 0, 0, 4, 5, 3, 0]


def test_src_to_dst_maps():
    # wide (gltf_model_reader.rs:752-761)
    res = generate_src_to_dst_map({"r": 0, "g": 1, "b": 2},
                                  {"r": 0, "g": 1, "b": 2, "a": 3})
    assert res == {0: 0, 1: 1, 2: 2}
    # narrow (:763-771)
    res = generate_src_to_dst_map({"r": 0, "g": 1, "b": 2, "a": 3},
                                  {"r": 0, "g": 1, "b": 2})
    assert res == {0: 0, 1: 1, 2: 2}
    # wide mix (:773-782)
    res = generate_src_to_dst_map({"r": 0, "g": 1, "b": 2, "a": 3},
                                  {"b": 0, "g": 1, "r": 2})
    assert res == {0: 2, 1: 1, 2: 0}


@pytest.fixture(scope="module")
def box():
    return GltfModelReader.open(box_path(), normalize_vectors=True,
                                coerce_image_to_format="B8G8R8A8_UNORM")


def test_textured_cube_golden(box):
    """gltf_model_reader.rs:784-855, on the generated cube."""
    sphere = box.get_primitives_bounding_sphere()
    # Ritter's two-pass sphere is approximate: it must contain every
    # corner of the unit cube, and its value is pinned
    assert abs(sphere.radius - 1.0758315) < 1e-5
    corners = box.primitive_arrays()[0]["positions"]
    assert (np.linalg.norm(corners - sphere.center, axis=1)
            <= sphere.radius + 1e-5).all()

    attrs = (MeshAttributeType.VERTICES | MeshAttributeType.NORMALS
             | MeshAttributeType.TEX_COORDS | MeshAttributeType.INDICES)
    info = box.copy_model_data(attrs, TextureType.ALBEDO, None)
    total = info.compute_total_size()
    assert total > 0

    buf = bytearray(total)
    info = box.copy_model_data(attrs, TextureType.ALBEDO, buf)
    prim = info.get_primitive_data()[0]

    first_vertex = np.frombuffer(bytes(buf), np.float32,
                                 count=8, offset=prim.mesh_buffer_offset)
    ref = np.array([-0.5, -0.5, 0.5, 0.0, 1.0, 0.0, 0.0, 1.0], np.float32)
    # interleave order is [pos | uv | normal] for this attribute set
    np.testing.assert_allclose(first_vertex, ref, atol=1e-7)

    first_indices = np.frombuffer(bytes(buf), np.uint16,
                                  count=6, offset=prim.indices_buffer_offset)
    assert first_indices.tolist() == [0, 1, 2, 0, 2, 3]

    first_texels = np.frombuffer(bytes(buf), np.uint8,
                                 count=4, offset=prim.image_buffer_offset)
    # RGB (237, 227, 221) coerced to B8G8R8A8; the source has no alpha
    assert first_texels.tolist() == [221, 227, 237, 0]
    assert prim.image_extent == (256, 256, 1)


def test_full_attribute_layout(box):
    """The renderer's attribute set (vk_model.rs:503-508) minus tangents
    (the plain cube has none); element size must be 12B pos + 8B uv + 12B n."""
    attrs = (MeshAttributeType.VERTICES | MeshAttributeType.TEX_COORDS
             | MeshAttributeType.NORMALS | MeshAttributeType.INDICES)
    info = box.copy_model_data(attrs, TextureType.ALBEDO, None)
    prim = info.get_primitive_data()[0]
    assert prim.single_mesh_element_size == 32
    assert prim.single_index_size == 2
    assert prim.image_layers == 1
    assert prim.image_format == "B8G8R8A8_UNORM"


def test_primitive_arrays(box):
    prims = box.primitive_arrays()
    assert len(prims) == 1
    p = prims[0]
    assert p["positions"].shape[1] == 3
    assert p["indices"].shape[1] == 3
    assert p["tex_coords"].shape[0] == p["positions"].shape[0]
    assert TextureType.ALBEDO in p["textures"]
    img = p["textures"][TextureType.ALBEDO]
    assert img.format == "B8G8R8A8_UNORM"
    assert img.as_array().shape == (img.height, img.width, 4)


def test_tangent_model():
    m = GltfModelReader.open(
        box_tangents_path(),
        normalize_vectors=True, coerce_image_to_format="B8G8R8A8_UNORM")
    p = m.primitive_arrays()[0]
    assert p["tangents"] is not None and p["tangents"].shape[1] == 4
    # interleaved stream must be 48 bytes per vertex = the shader's VertexData
    attrs = (MeshAttributeType.VERTICES | MeshAttributeType.TEX_COORDS
             | MeshAttributeType.NORMALS | MeshAttributeType.TANGENTS
             | MeshAttributeType.INDICES)
    info = m.copy_model_data(attrs, TextureType.ALBEDO, None)
    assert info.get_primitive_data()[0].single_mesh_element_size == 48


def test_non_png_texture_needs_pillow(monkeypatch):
    """A JPEG texture decodes through Pillow; without it the error names
    the missing package."""
    import sys

    from tpurt.scene.gltf import _decode_image_bytes

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        _decode_image_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF")


def test_generated_box_is_deterministic(tmp_path):
    """The stand-in asset is the same bytes from the same seed, and the
    seed changes the texture only."""
    from tpurt.scene.procedural import write_textured_box_glb

    a = write_textured_box_glb(str(tmp_path / "a.glb"))
    b = write_textured_box_glb(str(tmp_path / "b.glb"))
    c = write_textured_box_glb(str(tmp_path / "c.glb"), seed=1)
    assert open(a, "rb").read() == open(b, "rb").read()
    pa = GltfModelReader.open(a).primitive_arrays()[0]
    pc = GltfModelReader.open(c).primitive_arrays()[0]
    np.testing.assert_array_equal(pa["positions"], pc["positions"])
    assert not np.array_equal(pa["textures"][TextureType.ALBEDO].pixels,
                              pc["textures"][TextureType.ALBEDO].pixels)
