"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-device sharding is validated the standard JAX way (SURVEY.md section
4, item 4): an 8-device host-platform mesh stands in for several cards.
The platform is also set through jax.config, before any computation runs,
so a JAX_PLATFORMS value from the environment cannot select another
backend. Tests marked ``gpu`` need a CUDA card and skip without one.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# NOTE: the persistent compilation cache is deliberately NOT enabled: this
# image's XLA:CPU AOT loader rejects its own cache entries with machine-
# feature mismatch errors (cpu_aot_loader.cc) and warns about SIGILL.

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """A CUDA device, probed at test time in a child process (this process
    is pinned to the CPU); skips when there is none."""
    import subprocess

    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices('cuda')[0].device_kind)"],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    if probe.returncode != 0:
        pytest.skip("no CUDA device")
    return probe.stdout.strip().splitlines()[-1]
