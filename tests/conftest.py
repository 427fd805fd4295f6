"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is tested without accelerator hardware by
forcing the CPU backend with 8 virtual devices (SURVEY.md §4: the
collective top-k merge is testable single-host this way); the Hopper
kernel runs in Pallas interpret mode. Set LIBSSA_TEST_ACCELERATOR=1 to run
on whatever accelerator JAX finds instead — the hardware lane is
``pytest -m gpu tests/test_gpu.py`` (chip_smoke.py runs it on the card).
"""
import os

import pytest

ON_ACCELERATOR = bool(os.environ.get("LIBSSA_TEST_ACCELERATOR"))

if not ON_ACCELERATOR:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


# Every XLA:CPU executable holds ~3.5 memory mappings of JIT'd code for
# the life of the process; the full suite compiles thousands of programs,
# so one pytest process crosses the kernel's vm.max_map_count ceiling
# (default 65530) around test ~300 and LLVM's next mmap fails with a
# hard SIGSEGV inside backend_compile_and_load (measured: maps grew to
# 63k+ thirty seconds before a deterministic crash in test_sharded; a
# jax.clear_caches() + gc drops the count right back — verified 865->501
# over two compile/clear cycles of 120 programs). Clearing at a high
# watermark keeps the suite far from the ceiling and only costs
# recompiles from that point on.
_MAPS_HIGH_WATER = 35_000


@pytest.fixture(autouse=True)
def _bound_jit_code_maps():
    yield
    if ON_ACCELERATOR:
        return  # XLA:CPU's map-count ceiling; never clear a card's programs
    try:
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
    except OSError:  # non-Linux: no /proc, and no map-count ceiling
        return
    if n_maps > _MAPS_HIGH_WATER:
        import gc

        import jax

        jax.clear_caches()
        gc.collect()
