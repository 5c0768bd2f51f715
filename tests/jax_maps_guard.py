"""A pytest plugin that keeps a test process under ``vm.max_map_count``.

Every XLA:CPU executable that a process keeps loaded holds thousands of
memory mappings (one test of tests/test_msm.py or tests/test_aggregate.py
leaves up to about 29,000), and the kernel caps them per process (65530 by
default); past the cap the next compile or compile-cache read segfaults and
takes the xdist worker down with it (see tests/conftest.py). Whether a worker
gets there depends only on which tests xdist happens to hand it in a row.

Before each test, where the process holds more than ``MAPS_HIGH`` mappings,
this plugin drops the compiled JAX programs that earlier tests left loaded
(``jax_release._release``), so that the test starts with room for its own.
A test that needs a released program again compiles it anew or reads it from
the compile cache; no test sees a different result. Below the mark it does
nothing.

The port's test modules turn it on with ``pytest_plugins = ["jax_maps_guard"]``,
which registers it for the whole process once pytest has imported one of them.

``releases`` counts the releases of this process, and each release is
recorded on the test it ran before as the property ``jax_maps_release``
(its value: the mappings held, then this process's count), so a run's
JUnit XML counts them over every worker:
``grep -c 'name="jax_maps_release"' run.xml``.
"""
import jax_release

# Room left for the next test: 65530 - MAPS_HIGH, about twice the most that
# any one test of the suite has been seen to add.
MAPS_HIGH = 1 << 14
releases = 0


def _maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:                   # no procfs: nothing to guard
        return 0


def pytest_runtest_setup(item):
    global releases
    maps = _maps()
    if maps > MAPS_HIGH:
        jax_release._release()
        releases += 1
        item.user_properties.append(("jax_maps_release",
                                     f"{maps} maps, release {releases}"))
