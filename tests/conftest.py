"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-device meshes are stood in by XLA's host-platform device
virtualization (SURVEY.md §4). The platform is forced through jax.config
after import, which wins as long as no array op ran yet (backends
initialize lazily).

Tests that need the GPU carry the ``gpu`` marker (registered in pytest.ini)
and skip here; ``chip_smoke.py`` runs their checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

from smarc_navigation_tpu import compile_cache  # noqa: E402

# persistent compile cache makes repeat test runs cheap
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

assert jax.devices()[0].platform == "cpu" and len(jax.devices()) == 8


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when the process has no GPU (decided per
    test, never at import: xdist workers must all collect the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
