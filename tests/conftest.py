"""Test-environment shims so the suite runs in minimal containers.

1. ``hypothesis`` fallback: several modules use hypothesis property tests.
   When the real library is absent (it is not part of the runtime deps), a
   tiny deterministic stub is registered instead: ``@given`` draws
   ``max_examples`` pseudo-random examples from the declared strategies with
   a fixed seed.  This keeps the property tests *running* (fixed-seed random
   sampling, no shrinking / database / edge-case heuristics) rather than
   failing at collection.  With real hypothesis installed the stub is inert.

   Stub mode is announced in the pytest report header, and CI's stub leg
   sets ``REPRO_HYPOTHESIS_STUB=skip`` so the stub-sampled tests report as
   *skipped* with a reason instead of passing under degraded coverage —
   the matrix's real-hypothesis leg is where they count.

2. Kernel tests (``test_kernels.py``, ``test_engine_kernels.py``) run on
   every container: kernels resolve the Pallas TPU CompilerParams class
   through ``repro.kernels._compat`` (``CompilerParams`` vs the older
   ``TPUCompilerParams`` spelling, or None when the TPU backend is
   absent), and the tests pin ``interpret=True`` so no Mosaic lowering
   is required.  The compiled leg is auto-selected by the ``ops.py``
   dispatch wrappers when the default backend is a real TPU.
"""

import importlib.util
import os
import random
import sys
import types

_HYPOTHESIS_STUBBED = importlib.util.find_spec("hypothesis") is None
_STUB_SKIP = os.environ.get("REPRO_HYPOTHESIS_STUB", "run") == "skip"

# --- 1. hypothesis fallback stub -------------------------------------------

if _HYPOTHESIS_STUBBED:
    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _floats(min_value=0.0, max_value=1.0, **kw):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def _integers(min_value=0, max_value=100):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def _lists(elem, min_size=0, max_size=10):
        return _Strategy(lambda r: [elem.draw(r)
                                    for _ in range(r.randint(min_size,
                                                             max_size))])

    def _sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda r: r.choice(items))

    def _given(*args, **kwargs):
        def deco(fn):
            def wrapper():
                if _STUB_SKIP:
                    import pytest
                    pytest.skip("hypothesis stub active (fixed-seed "
                                "sampling, no shrinking); the real-"
                                "hypothesis matrix leg runs this test")
                n = getattr(wrapper, "_stub_max_examples", 20)
                r = random.Random(1234)
                for _ in range(n):
                    fn(**{name: s.draw(r) for name, s in kwargs.items()})
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    def _settings(max_examples=20, deadline=None, **kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.floats = _floats
    _strategies.integers = _integers
    _strategies.lists = _lists
    _strategies.sampled_from = _sampled_from

    _hypothesis = types.ModuleType("hypothesis")
    _hypothesis.given = _given
    _hypothesis.settings = _settings
    _hypothesis.strategies = _strategies
    _hypothesis.__is_stub__ = True

    sys.modules["hypothesis"] = _hypothesis
    sys.modules["hypothesis.strategies"] = _strategies

# --- 2. pytest hooks ---------------------------------------------------------
# (test_kernels.py gates itself on the Pallas TPU API surface with a
# module-level pytest.skip, so its absence shows up as a skip with a reason
# rather than a silent collect_ignore.)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


def pytest_report_header(config):
    if not _HYPOTHESIS_STUBBED:
        return "hypothesis: real library (shrinking + edge cases active)"
    mode = ("SKIPPING property tests (REPRO_HYPOTHESIS_STUB=skip)"
            if _STUB_SKIP else
            "fixed-seed sampling, no shrinking (set "
            "REPRO_HYPOTHESIS_STUB=skip to surface them as skips)")
    return f"hypothesis: STUB — {mode}"
