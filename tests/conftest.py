"""Test harness configuration.

Tests run on a simulated 8-device CPU platform so multi-device sharding
code (mesh/pjit paths) executes without GPUs — the standard JAX
technique for testing pjit programs (SURVEY.md §4 item 5). The env vars
must be set before jax initializes a backend, hence at conftest import
time.
"""

import os

# Force CPU even on a GPU host: unit tests must be hermetic and exercise
# the simulated 8-device mesh. Also override via jax.config, which wins
# at backend-selection time. Tests that need the card are marked `gpu`
# and decide inside the test whether one exists (chip_smoke.py runs
# their phases on the card).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def interpret_fused(monkeypatch):
    """Build the apps' predictors with the fused kernel in the Pallas
    interpreter — the CPU backend cannot compile the Triton kernel."""
    import functools

    from radarml_tpu.apps import predict as predict_app
    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.models.pipeline import RadarPredictor

    for app in (predict_app, serve_app):
        monkeypatch.setattr(
            app, "RadarPredictor",
            functools.partial(RadarPredictor, interpret=True),
        )
