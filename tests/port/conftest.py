"""Keeps a test process under the kernel's per-process memory-map limit.

XLA keeps every program a process compiled mapped into memory, about three
maps each, until ``jax.clear_caches()`` drops them.  The JAX suite's
randomized serve harnesses compile thousands of small programs: one paged
harness alone adds up to ~36,000 maps, and a process that runs three of them
in a row passes ``vm.max_map_count`` (65530 by default) and dies inside
XLA's compiler.  Which tests share a process depends on how xdist hands out
batches, and so on how many tests are collected, the port's included.

So before each test of the session, a process that would pass the limit if
the test added as many maps as the heaviest harness (with some margin) drops
JAX's compiled programs, and the test starts with room for that harness.  A
process below that line keeps its programs, so most tests recompile nothing.  A test's own programs are never dropped while it runs,
and the checks it makes are unchanged: only recompilation can cost time.
``pytest_runtest_protocol`` is called through ``config.hook``, so this hook
runs for every test in the session, not only for those in this folder."""
import gc
import sys

import pytest

_MAPS = "/proc/self/maps"


def _map_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


def _maps_held() -> int:
    try:
        with open(_MAPS) as f:
            return sum(1 for _ in f)
    except OSError:  # no procfs: nothing to measure, nothing to drop
        return 0


# the maps one test may add: the heaviest paged harness's ~36,000, with margin
_HEAVIEST_TEST_MAPS = 40_000
_DROP_ABOVE = max(_map_limit() - _HEAVIEST_TEST_MAPS, 0)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_protocol(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is not None and _maps_held() > _DROP_ABOVE:
        jax.clear_caches()
        gc.collect()
