"""Generated test assets (nothing is downloaded).

`box_path()` is the textured cube that stands in for glTF-Sample-Models'
BoxTextured.glb: written once per process by the `textured_box` session
fixture (conftest.py), or on first use outside pytest (tests/regen_goldens.py).
"""
import os
import tempfile

from tpurt.scene.procedural import write_textured_box_glb

_PATHS = {}


def write_assets(directory) -> None:
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    _PATHS["box"] = write_textured_box_glb(
        os.path.join(directory, "BoxTextured.glb"))
    _PATHS["box_tangents"] = write_textured_box_glb(
        os.path.join(directory, "BoxTexturedWithTangents.glb"),
        tangents=True)


def _path(key: str) -> str:
    if key not in _PATHS:
        write_assets(tempfile.mkdtemp(prefix="tpurt-assets-"))
    return _PATHS[key]


def box_path() -> str:
    return _path("box")


def box_tangents_path() -> str:
    return _path("box_tangents")
