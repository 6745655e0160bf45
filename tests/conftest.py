"""Test configuration: hermetic CPU backend.

The suite runs on the CPU backend unless JAX_PLATFORMS says otherwise (the
tests marked ``gpu`` are run on a GPU host with ``JAX_PLATFORMS=cuda,cpu``).
The main suite is single-device; forcing many virtual CPU devices in one
process can deadlock XLA:CPU's thread pools on small hosts, so multi-device
sharding semantics are exercised in dedicated subprocess tests
(tests/test_parallel.py) with a small virtual device count.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Some virtual machines advertise AVX-512 in cpuid but fault on (some of)
# it: XLA:CPU then intermittently SIGSEGVs inside compile-and-load deep into
# long suites. Cap the ISA so the JIT never emits those instructions.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# NO persistent compile cache: XLA:CPU executable serialization is unsafe on
# such hosts (cross-machine feature mismatch on load — "+prefer-no-scatter
# ... could lead to SIGILL" — and a reproducible segfault inside
# executable.serialize() when writing the fused-scan program). Repeat runs
# pay the compile; correctness beats speed here.


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU aborts (silently, inside backend_compile_and_load) when one
    process accumulates several hundred large compiled programs — the full
    suite reproducibly died around test ~145 compiling the fused tracking
    scan, while every module passes standalone. Dropping the executable
    caches at module boundaries bounds the accumulation; modules recompile
    what they need (the suite is cold-compile anyway, see the cache note
    above)."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a GPU host)")
    return devs[0]
