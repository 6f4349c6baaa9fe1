"""Test configuration: the CPU backend with 8 virtual devices by default.

Tests run on an 8-device virtual CPU mesh so sharding tests exercise real
collectives (``__graft_entry__.py`` dry-runs the multi-device path). A set
``JAX_PLATFORMS`` is honoured instead, so ``JAX_PLATFORMS=cuda pytest -m
gpu`` runs the GPU-only tests on a card; the ``gpu`` fixture skips them
everywhere else.
"""

import os

# The full suite compiles thousands of XLA programs; each leaves JIT code
# mappings behind, and the kernel default vm.max_map_count=65530 is hit at
# ~85% of the run (the process then segfaults inside LLVM). Raise the limit
# when we can (root in this microVM); harmless no-op otherwise.
try:
    with open("/proc/sys/vm/max_map_count") as _fh:
        if int(_fh.read()) < 262144:
            with open("/proc/sys/vm/max_map_count", "w") as _out:
                _out.write("1048576")
except (OSError, ValueError):
    pass

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_TRACEBACK_FILTERING", "off")

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu on a card")

# ---------------------------------------------------------------------------
# Smoke tier: `pytest -m smoke` runs a <5 min representative slice that still
# touches every test module. Selection is automatic from the checked-in
# durations table (tests/durations.json, regenerated from a full
# `--durations=0` run): per module, the fastest tests are marked smoke until
# the module's budget is spent, so every module keeps at least one
# representative. Tests absent from the table (new tests) are charged an
# assumed duration against the same budget — so a burst of new tests cannot
# silently blow the <5-min tier before the table is re-baselined.
# ---------------------------------------------------------------------------
import json  # noqa: E402

# Cut against the 578-test duration table: predicted smoke call time 170 s
# + ~95 s fixed overhead lands ~265 s, >=20% margin under a 330 s budget.
_SMOKE_BUDGET_PER_MODULE = 4.5  # seconds of recorded call time per module
_ASSUMED_UNKNOWN_DURATION = 2.0  # budget charge for tests not in the table


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "smoke: fast representative slice (auto-selected)"
    )


def _load_durations():
    path = os.path.join(os.path.dirname(__file__), "durations.json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def pytest_collection_modifyitems(config, items):
    import pytest

    durations = _load_durations()
    by_module: dict = {}
    for item in items:
        by_module.setdefault(item.fspath.basename, []).append(item)
    for module_items in by_module.values():
        ranked = sorted(
            (
                (durations.get(i.nodeid, _ASSUMED_UNKNOWN_DURATION), i)
                for i in module_items
            ),
            key=lambda pair: pair[0],
        )
        smoke = set()
        spent = 0.0
        for dur, item in ranked:
            if spent + dur > _SMOKE_BUDGET_PER_MODULE and smoke:
                break
            smoke.add(item)
            spent += dur
        if not smoke and ranked:  # every test slow: keep the fastest one
            smoke.add(ranked[0][1])
        for item in smoke:
            item.add_marker(pytest.mark.smoke)
