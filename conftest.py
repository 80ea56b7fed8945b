# Root conftest: the test suite runs on a deterministic 8-virtual-device CPU
# platform (multi-device sharding is validated on a virtual CPU mesh). Tests
# marked `gpu` need the card: run them there with
#   TPURT_GPU_TESTS=1 python -m pytest -m gpu tests/
# which leaves JAX on its default (GPU) platform; they skip everywhere else.
import os
import sys

_gpu_run = os.environ.get("TPURT_GPU_TESTS") == "1"
if not _gpu_run:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))

import jax  # noqa: E402
import pytest  # noqa: E402

from tpurt.utils.cache import setup_compile_cache  # noqa: E402

if not _gpu_run:
    jax.config.update("jax_platforms", "cpu")
setup_compile_cache()


@pytest.fixture(scope="session", autouse=True)
def textured_box(tmp_path_factory):
    """The generated textured cube .glb (tests/assets.py), written once per
    test process."""
    import assets

    assets.write_assets(tmp_path_factory.mktemp("assets"))
    return assets.box_path()


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run TPURT_GPU_TESTS=1 python -m "
                    "pytest -m gpu tests/ on the card")
    return jax.devices()[0]


@pytest.fixture
def gpu_kernel_path(monkeypatch):
    """Routes the tracer entry (kernels/trace.py) to the Triton traversal
    kernel, which runs in the Pallas interpreter off the GPU. Jitted frames
    are traced afresh on both sides of the switch."""
    from tpurt.kernels import trace

    jax.clear_caches()
    monkeypatch.setattr(trace, "use_gpu_kernel", lambda: True)
    yield
    jax.clear_caches()
