"""XLA compile time each test spends in the JAX package (the reference)
on the CPU, as a pytest plugin.

    PYTHONPATH=tools JAX_PLATFORMS=cpu python -m pytest -q \\
        -p no:cacheprovider -p reference_compile_times \\
        tests/test_torch_port_detection_zoo.py \\
        tests/test_torch_port_segmentation_zoo.py

It wraps ``pxla.UnloadedMeshExecutable.from_hlo``, through which every
jitted program and every eagerly dispatched primitive is compiled, and
prints after the run one line a test: the seconds spent compiling,
the programs compiled and the test's wall seconds (set-up, call and
tear-down together, as junit's ``time``), then the total.  A module
fixture's compiles count to the first test that uses it.
"""
import collections
import time

import pytest

_COMPILE = {"s": 0.0, "n": 0}
_PER_TEST = collections.OrderedDict()


def pytest_configure(config):
    from jax._src.interpreters import pxla
    compile_hlo = pxla.UnloadedMeshExecutable.from_hlo

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return compile_hlo(*args, **kwargs)
        finally:
            _COMPILE["s"] += time.perf_counter() - t0
            _COMPILE["n"] += 1
    pxla.UnloadedMeshExecutable.from_hlo = staticmethod(timed)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    s0, n0, t0 = _COMPILE["s"], _COMPILE["n"], time.perf_counter()
    yield
    _PER_TEST[item.nodeid] = (_COMPILE["s"] - s0, _COMPILE["n"] - n0,
                              time.perf_counter() - t0)


def pytest_unconfigure(config):
    for nodeid, (s, n, wall) in _PER_TEST.items():
        print(f"compile {s:7.2f} s {n:5d} programs  wall {wall:7.2f} s  "
              f"{nodeid}")
    print(f"compile total {sum(v[0] for v in _PER_TEST.values()):.2f} s, "
          f"wall total {sum(v[2] for v in _PER_TEST.values()):.2f} s")
