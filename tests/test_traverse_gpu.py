"""The Triton traversal kernel (kernels/traverse_gpu.py) against the XLA
tracer (kernels/traverse.py) and the brute-force oracle, and the tracer
entry's choice between them (kernels/trace.py).

Off the GPU the kernel runs in the Pallas interpreter, so these cases check
its control flow and arithmetic here; `test_compiled_kernel_matches_xla`
checks the compiled kernel on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh import build_bvh_sah, build_lbvh
from tpurt.bvh.flat import tri_aabbs
from tpurt.kernels import trace, traverse, traverse_gpu
from tpurt.kernels.traverse import make_traversal_geom, trace_closest_brute
from tpurt.scene.procedural import _cube

from test_bvh import random_rays, random_tris


def _scene(kind):
    """(bvh pytree, geom, max_leaf) for a test scene."""
    if kind == "cubes":
        # axis-aligned cubes on integer coordinates: rays along an axis
        # with an origin on a box plane give 0 * inf = NaN slabs
        parts = [_cube(np.array(c, np.float32), 0.5, 2)
                 for c in ((0, 0, 0), (2, 0, 0), (0, 2, 1), (-2, -1, 2))]
        v0, v1, v2 = [], [], []
        for pos, _, _, idx in parts:
            v0.append(pos[idx[:, 0]])
            v1.append(pos[idx[:, 1]])
            v2.append(pos[idx[:, 2]])
        v0, v1, v2 = (np.concatenate(a) for a in (v0, v1, v2))
    else:
        v0, v1, v2 = random_tris(300, seed=21)
    amin, amax = tri_aabbs(v0, v1, v2)
    if kind == "lbvh":
        bvh, max_leaf = build_lbvh(amin, amax), 1
    else:
        bvh, max_leaf = build_bvh_sah(amin, amax, max_leaf_size=4), 4
    geom = make_traversal_geom(v0, v1, v2, bvh.tri_order)
    return jax.tree.map(jnp.asarray, bvh.as_pytree()), geom, max_leaf


def _rays(case, geom):
    """(origin, direction, t_min, t_max) for a ray case."""
    centers = np.asarray(geom["v0"]) + (np.asarray(geom["e1"])
                                        + np.asarray(geom["e2"])) / 3
    if case == "random":
        o, d = random_rays(300, seed=5, targets=centers)   # 300: padded
        return o, d, 1e-3, 1e4
    if case == "axis_parallel":
        rng = np.random.default_rng(6)
        axes = np.eye(3, dtype=np.float32)
        d = np.concatenate([axes, -axes])[rng.integers(0, 6, 256)]
        # every other origin lies on the half-integer lattice of the box
        # planes (NaN slabs, which miss in both tracers); the rest sit a
        # quarter off it and hit through +-inf slab products
        o = rng.integers(-6, 7, (256, 3)).astype(np.float32) * 0.5
        o[1::2] += 0.25
        o = np.where(d != 0, -6.0 * d, o)   # start outside along the axis
        return jnp.asarray(o), jnp.asarray(d), 1e-3, 1e4
    if case == "all_miss":
        o, d = random_rays(256, seed=7)
        return o + 100.0, -jnp.abs(d) - 0.1, 1e-3, 1e4   # away from scene
    if case == "parked":
        o, d = random_rays(256, seed=8, targets=centers)
        t_max = np.where(np.arange(256) % 3 == 0, 0.0, 1e4)
        return o, d, 1e-3, jnp.asarray(t_max, jnp.float32)
    raise ValueError(case)


CASES = [("random", "sah"), ("random", "lbvh"), ("axis_parallel", "cubes"),
         ("all_miss", "sah"), ("parked", "sah"), ("random", "cubes")]


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("case,kind", CASES)
def test_closest_matches_xla(case, kind, block):
    bvh, geom, max_leaf = _scene(kind)
    o, d, tmin, tmax = _rays(case, geom)
    got = traverse_gpu.trace_closest(bvh, geom, o, d, tmin, tmax,
                                     max_leaf=max_leaf, block=block)
    ref = traverse.trace_closest(bvh, geom, o, d, tmin, tmax,
                                 max_leaf=max_leaf)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(ref["tri"]))
    hit = np.asarray(ref["tri"]) >= 0
    # same arithmetic; XLA may order the 3-term dot products differently
    np.testing.assert_allclose(np.asarray(got["t"]), np.asarray(ref["t"]),
                               rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(got[k])[hit],
                                   np.asarray(ref[k])[hit], atol=1e-5)
    if case == "all_miss":
        assert not hit.any()
    if case == "parked":
        assert not hit[::3].any()
    if case in ("random", "axis_parallel"):
        assert hit.sum() > 10, "the case must produce hits"


@pytest.mark.parametrize("block", [64, 128, 256])
@pytest.mark.parametrize("case,kind", CASES)
def test_any_matches_xla(case, kind, block):
    bvh, geom, max_leaf = _scene(kind)
    o, d, tmin, tmax = _rays(case, geom)
    got = traverse_gpu.trace_any(bvh, geom, o, d, tmin, tmax,
                                 max_leaf=max_leaf, block=block)
    ref = traverse.trace_any(bvh, geom, o, d, tmin, tmax, max_leaf=max_leaf)
    assert got.dtype == jnp.bool_ and got.shape == (o.shape[0],)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("kind", ["sah", "lbvh"])
def test_closest_matches_brute_force(kind):
    bvh, geom, max_leaf = _scene(kind)
    o, d, tmin, tmax = _rays("random", geom)
    got = traverse_gpu.trace_closest(bvh, geom, o, d, tmin, tmax,
                                     max_leaf=max_leaf)
    ref = trace_closest_brute(geom, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(ref["tri"]))
    hit = np.asarray(ref["tri"]) >= 0
    np.testing.assert_allclose(np.asarray(got["t"])[hit],
                               np.asarray(ref["t"])[hit], rtol=1e-5)


def test_short_leaves_are_exercised():
    """The SAH scene has leaves holding fewer than MAX_LEAF triangles, so
    the kernel's `k < count` masks are exercised by the cases above."""
    bvh, _, max_leaf = _scene("sah")
    counts = np.asarray(bvh["tri_count"])
    leaf = counts[counts > 0]
    assert max_leaf == 4 and (leaf < 4).any() and (leaf == 4).any()


def test_entry_picks_xla_off_gpu(monkeypatch):
    """On CPU the tracer entry runs the XLA tracer, not the kernel."""
    assert jax.default_backend() == "cpu"
    assert not trace.use_gpu_kernel()
    calls = []

    def fail(*a, **k):
        calls.append(a)
        raise AssertionError("the GPU kernel must not run off the GPU")

    monkeypatch.setattr(traverse_gpu, "trace_closest", fail)
    monkeypatch.setattr(traverse_gpu, "trace_any", fail)
    bvh, geom, max_leaf = _scene("sah")
    o, d, tmin, tmax = _rays("random", geom)
    got = trace.trace_closest(bvh, geom, o, d, tmin, tmax, max_leaf=max_leaf)
    ref = traverse.trace_closest(bvh, geom, o, d, tmin, tmax,
                                 max_leaf=max_leaf)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(ref["tri"]))
    occ = trace.trace_any(bvh, geom, o, d, tmin, tmax, max_leaf=max_leaf)
    assert occ.shape == (o.shape[0],) and not calls


@pytest.mark.parametrize("any_hit", [False, True])
def test_entry_compiles_kernel_on_gpu(monkeypatch, any_hit):
    """With a GPU backend the entry routes to the kernel, and the kernel's
    pallas_call is never made in interpret mode there."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert trace.use_gpu_kernel()
    seen = []

    def fake_pallas_call(kernel, *, out_shape, interpret, backend, **kw):
        seen.append(dict(interpret=interpret, backend=backend,
                         grid=kw["grid"]))

        def run(*args):
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                out_shape)
        return run

    monkeypatch.setattr(pl, "pallas_call", fake_pallas_call)
    bvh, geom, max_leaf = _scene("sah")
    o, d, tmin, tmax = _rays("random", geom)
    fn = trace.trace_any if any_hit else trace.trace_closest
    # eval_shape traces the wrapper without compiling (there is no GPU);
    # the caches are cleared so no trace made with the fake call survives
    jax.clear_caches()
    try:
        jax.eval_shape(lambda o, d: fn(bvh, geom, o, d, tmin, tmax,
                                       max_leaf=max_leaf), o, d)
    finally:
        jax.clear_caches()
    assert seen == [dict(interpret=False, backend="triton",
                         grid=(-(-300 // traverse_gpu.BLOCK),))]


@pytest.mark.gpu
@pytest.mark.parametrize("block", [64, 128, 256])
def test_compiled_kernel_matches_xla(gpu, block):
    """On the card: the compiled kernel against the XLA tracer."""
    bvh, geom, max_leaf = _scene("sah")
    o, d, tmin, tmax = _rays("random", geom)
    got = traverse_gpu.trace_closest(bvh, geom, o, d, tmin, tmax,
                                     max_leaf=max_leaf, block=block)
    ref = traverse.trace_closest(bvh, geom, o, d, tmin, tmax,
                                 max_leaf=max_leaf)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(ref["tri"]))
    occ = traverse_gpu.trace_any(bvh, geom, o, d, tmin, tmax,
                                 max_leaf=max_leaf, block=block)
    np.testing.assert_array_equal(
        np.asarray(occ),
        np.asarray(traverse.trace_any(bvh, geom, o, d, tmin, tmax,
                                      max_leaf=max_leaf)))
