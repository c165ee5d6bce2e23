"""Test configuration: a deterministic 8-virtual-device CPU backend.

Sharding tests run on a simulated 8-device mesh
(``--xla_force_host_platform_device_count=8``, SURVEY.md §4) so that
``shard_map`` correctness is validated without several real devices.
The Pallas kernel runs here in interpret mode, reached through the
explicit ``interpret=True`` argument of its launch function.

Tests that need an NVIDIA GPU take the ``gpu`` fixture (and the ``gpu``
marker); they skip on the CPU and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Any
``JAX_PLATFORMS`` other than ``cpu`` leaves the platform to JAX.
"""

import os

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    # XLA_FLAGS must be set before the CPU backend is first initialized
    os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # f64 available for parity tests

# CPU wavefront programs take seconds-to-minutes to compile; cache them
# across runs (keyed on jaxpr, so source edits invalidate precisely)
from raytrace_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(os.environ.get(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache_cpu")))

if ON_CPU:
    assert jax.default_backend() == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        + jax.default_backend())
    assert jax.device_count() == 8

# ---------------------------------------------------------------------------
# Shared path anchors (no hardcoded checkout locations)

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
# the reference's golden scene, committed as a DSL file
GOLDEN_SCENE = REPO_ROOT / "examples" / "test_scene.txt"
# upstream reference snapshot (its rendered out.bmp and sources cannot
# be rebuilt from this repository); optional — tests needing it skip
REFERENCE_DIR = Path(os.environ.get("RAYTRACE_TPU_REFERENCE_DIR",
                                    "/root/reference"))


def reference_path(*parts) -> Path:
    """Path under the reference snapshot, skipping if unavailable."""
    p = REFERENCE_DIR.joinpath(*parts)
    if not p.exists():
        pytest.skip(f"reference snapshot not available: {p}",
                    allow_module_level=True)
    return p


def repo_path(*parts) -> Path:
    return REPO_ROOT.joinpath(*parts)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test,
    never at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` "
                    "on a card")
