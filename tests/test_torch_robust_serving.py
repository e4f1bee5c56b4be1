"""``python -m repro_torch.robust_serving`` against
``examples/robust_serving.py``, on the CPU.

Both run the example's spec with its starts and Adam steps cut down (8
and 60), from the same starts: the JAX tuners' own draw from the spec's
seed, handed to the port as ``run_experiment``'s provider.  Tolerances are
``tests/test_torch_api.py``'s for the API suites' tunings: the same chosen
arm and design in every cell, each arm's exact re-scored cost and
objective to rel 1e-4.  The printed picks are the example's line for line
(the costs and throughput deltas masked, as they are held above).
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.api as R
from repro_torch import robust_serving as RS
from repro_torch.core import LSMSystem
from repro_torch.core.designs import n_params

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "robust_serving.py"


def _example():
    spec = importlib.util.spec_from_file_location("robust_serving_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_starts(design, n_starts, seed):
    """The JAX tuners' own draw (``designs.random_inits``) as a port
    starts provider."""
    draw = jax.random.uniform(jax.random.PRNGKey(seed),
                              (n_starts, n_params(design, LSMSystem())),
                              minval=-3.0, maxval=3.0)
    return torch.from_numpy(np.array(draw, np.float32))[None]


def _masked(text):
    text = text.replace("benchmarks.run", "repro_torch.bench.run")
    return re.sub(r"[-+]?\d+\.\d+%|\d+\.\d{3}\b", "#", text)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As ``tests/test_torch_api.py``'s: the tunings' lane batches are
    small, and torch's intra-op threads spin-wait beside other busy test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def example():
    ex = _example()
    return ex, _cut(ex.SPEC)


def _cut(spec):
    """``spec`` with 8 starts and 60 Adam steps."""
    return dataclasses.replace(spec, design=dataclasses.replace(
        spec.design, n_starts=8, steps=60))


def test_spec_is_the_example_s():
    assert RS.SPEC.to_json() == _example().SPEC.to_json()
    assert RS.SPEC.backend == "sharded"


def test_picks_match_the_example(example, capsys, monkeypatch):
    ex, jspec = example
    monkeypatch.setattr(ex, "SPEC", jspec)
    seen = []
    monkeypatch.setattr(ex, "run_experiment",
                        lambda spec: seen.append(R.run_experiment(spec))
                        or seen[-1])
    ex.main()
    want_out = capsys.readouterr().out
    (ref,) = seen
    got = RS.main("cpu", _cut(RS.SPEC), starts=_jax_starts)
    got_out = capsys.readouterr().out
    assert got.walls["tuning_devices"] == 1          # sharded: one chunk
    assert got.cells == ref.cells
    for cell in ref.cells:
        assert got.chosen[cell] == ref.chosen[cell], cell
        for pol in ("klsm", "lazy_leveling"):
            a, b = ref.tuning(cell, pol), got.tuning(cell, pol)
            assert b.design.value == a.design.value
            assert b.describe(got.sys) == a.describe(ref.sys)
            assert b.cost == pytest.approx(a.cost, rel=1e-4)
            assert got.arm_costs[cell][pol] == pytest.approx(
                ref.arm_costs[cell][pol], rel=1e-4)
    assert _masked(got_out) == _masked(want_out)
    assert got_out.count("robust pick") == 3
