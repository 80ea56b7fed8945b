"""Deliberately regenerate the golden-frame fixtures.

Run when a rendering change is INTENDED:
    JAX_PLATFORMS=cpu python tests/regen_goldens.py
(frame64.npz — the original golden — has its own provenance; this tool
only rewrites the fixtures it knows how to build.)
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import golden_scenes as gs

    def render_frame64():
        from test_frame import make_renderer

        out = make_renderer().render()
        return dict(image=np.asarray(out["image"]),
                    depth=np.asarray(out["depth"]),
                    ao=np.asarray(out["ao"]))

    for name, fn in [("frame64", render_frame64),
                     ("spotarea128", gs.render_spotarea),
                     ("bent64", gs.render_bent),
                     ("dynamic64", gs.render_dynamic)]:
        out = fn()
        path = os.path.join(gs.GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, **out)
        print(f"wrote {path}: " + ", ".join(
            f"{k}{v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
