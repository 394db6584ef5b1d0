"""Repo-root conftest: make src/ importable and run every test on the CPU
backend with a virtual 8-device mesh (SURVEY.md §5.4 — distributed tests
without a cluster). bench.py, chip_smoke.py and __graft_entry__.py do not
import this; they run on the accelerator. Tests that need the card are
marked ``gpu`` and decide inside a fixture whether to skip.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "src"))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.devices()[0].platform == "cpu", (
    "tests must run on the CPU backend, got " + repr(jax.devices()[:1]))
assert len(jax.devices()) == 8, "expected 8 forced host devices"
