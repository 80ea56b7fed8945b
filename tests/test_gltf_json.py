""".gltf (JSON + external buffer) loading — converted from BoxTextured.glb."""
import json
import struct

import numpy as np
import pytest

from assets import box_path
from tpurt.scene import GltfModelReader, MeshAttributeType, TextureType


@pytest.fixture()
def gltf_dir(tmp_path):
    with open(box_path(), "rb") as f:
        blob = f.read()
    offset = 12
    doc = None
    bin_chunk = b""
    while offset + 8 <= len(blob):
        clen, ctype = struct.unpack_from("<II", blob, offset)
        offset += 8
        data = blob[offset:offset + clen]
        offset += clen
        if ctype == 0x4E4F534A:
            doc = json.loads(data.decode())
        elif ctype == 0x004E4942:
            bin_chunk = data
    doc["buffers"][0]["uri"] = "scene.bin"
    (tmp_path / "scene.bin").write_bytes(bin_chunk)
    (tmp_path / "scene.gltf").write_text(json.dumps(doc))
    return tmp_path


def test_gltf_json_matches_glb(gltf_dir):
    a = GltfModelReader.open(box_path(), normalize_vectors=True,
                             coerce_image_to_format="R8G8B8A8_UNORM")
    b = GltfModelReader.open(str(gltf_dir / "scene.gltf"),
                             normalize_vectors=True,
                             coerce_image_to_format="R8G8B8A8_UNORM")
    pa = a.primitive_arrays()[0]
    pb = b.primitive_arrays()[0]
    np.testing.assert_array_equal(pa["positions"], pb["positions"])
    np.testing.assert_array_equal(pa["indices"], pb["indices"])
    np.testing.assert_array_equal(
        pa["textures"][TextureType.ALBEDO].pixels,
        pb["textures"][TextureType.ALBEDO].pixels)

    attrs = (MeshAttributeType.VERTICES | MeshAttributeType.TEX_COORDS
             | MeshAttributeType.NORMALS | MeshAttributeType.INDICES)
    ia = a.copy_model_data(attrs, TextureType.ALBEDO, None)
    ib = b.copy_model_data(attrs, TextureType.ALBEDO, None)
    assert ia.compute_total_size() == ib.compute_total_size()
