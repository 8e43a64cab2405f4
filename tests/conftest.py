"""Test configuration: JAX runs on a virtual 8-device CPU mesh.

Tests stay on the CPU unless DSM_TEST_GPU=1, which chip_smoke.py sets
for its `pytest -m gpu` phase on a machine with a card.  Tests that need
the card carry the `gpu` marker and take the `gpu_device` fixture, which
skips them when JAX finds no GPU.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

if os.environ.get("DSM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

# persistent compile cache (unless JAX_COMPILATION_CACHE_DIR names one):
# the wavefront step recompiles per frontier capacity bucket; caching
# makes reruns cheap on the small CI machine
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _resolve_ref_bin() -> None:
    """Point DSM_REF_BIN at a compiled reference before test modules
    import it.  Order: explicit env var, a prebuilt copy at /tmp/refsrc,
    the checkout's own .cache/refsrc, which is built on demand the way
    bench.py does when the reference sources are present."""
    if os.environ.get("DSM_REF_BIN"):
        return
    bins = ("builder", "metaenumerate", "metaserver")

    def ready(d):
        return all(os.path.exists(os.path.join(d, b)) for b in bins)

    dst = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "refsrc")
    for cand in ("/tmp/refsrc", dst):
        if ready(cand):
            os.environ["DSM_REF_BIN"] = cand
            return
    src = "/root/reference"
    if not os.path.exists(os.path.join(src, "Makefile")):
        return
    import shutil
    import subprocess

    try:
        if not os.path.exists(os.path.join(dst, "Makefile")):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        # serial make: the vendored recursive builds race under -j
        subprocess.run(["make", "builder", "metaenumerate", "metaserver"],
                       cwd=dst, check=True, capture_output=True, timeout=900)
    except (subprocess.SubprocessError, OSError):
        return
    if ready(dst):
        os.environ["DSM_REF_BIN"] = dst


# the gpu-marked tests never call the reference
if os.environ.get("DSM_TEST_GPU") != "1":
    _resolve_ref_bin()


@pytest.fixture(scope="session")
def toydata_dir(tmp_path_factory):
    from tests.make_toydata import make_toydata

    out = tmp_path_factory.mktemp("toydata")
    make_toydata(str(out))
    return str(out)


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided here, at run time, never while modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run: python chip_smoke.py on the card)")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
