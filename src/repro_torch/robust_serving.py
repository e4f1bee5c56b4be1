"""A robust re-tuning storm as one declarative experiment, on the port.

The port of ``examples/robust_serving.py``, with its ``SPEC``: an
uncertain ZippyDB-like serving mix, a rho storm (0.25 / 1 / 2), the
compaction policy as a discrete arm tuned jointly (``klsm`` and
``lazy_leveling``), and model scoring over a sampled benchmark set of
4,000 mixes.  ``backend="sharded"`` splits the flat problem axis one
chunk a card (on a host with one card, or on the CPU, one chunk).

    PYTHONPATH=src python -m repro_torch.robust_serving             # the card
    PYTHONPATH=src python -m repro_torch.robust_serving --device cpu

``main`` prints what the example prints and returns the report.  The spec
is data: ``python -m repro_torch.bench.run --spec serving_storm.json``
runs the same experiment with no code.
"""

from __future__ import annotations

import argparse

from .api import (DesignSpec, ExperimentSpec, WorkloadSpec,
                  run_experiment)
from .core import zippydb_like

RHOS = (0.25, 1.0, 2.0)

SPEC = ExperimentSpec(
    name="serving_storm",
    workload=WorkloadSpec(workloads=(tuple(zippydb_like()),), rhos=RHOS,
                          nominal=True, bench_n=4000),
    design=DesignSpec(policies=("klsm", "lazy_leveling"), n_starts=32,
                      steps=150),
    backend="sharded",     # device-sharded sweep; one chunk on one device
)


def main(device=None, spec: ExperimentSpec = SPEC, starts=None,
         verbose: bool = True):
    """Run ``spec`` (the example's by default) on ``device`` (the card
    unless ``"cpu"``), tunings from ``starts`` (``run_experiment``'s
    provider; None: the tuners' own draw), and print the picks."""
    say = print if verbose else (lambda *a, **k: None)
    report = run_experiment(spec, device=device, starts=starts)
    nom = report.tuning((0, None))
    say(f"nominal pick for expected mix: {nom.describe(report.sys)} "
        f"policy={report.chosen[(0, None)]} "
        f"(expected cost {nom.cost:.3f})")
    for rho in spec.workload.rhos:
        cell = (0, rho)
        rr = report.tuning(cell)
        d = report.delta_tp_vs_nominal(0, rho)
        say(f"rho={rho:4.2f}: robust pick {rr.describe(report.sys)} "
            f"policy={report.chosen[cell]} "
            f"(worst-case {rr.cost:.3f}; mean Delta-throughput vs nominal "
            f"over drifted mixes {d.mean():+.1%})")
    say("\nthe spec is data — save it and re-run with\n"
        "  python -m repro_torch.bench.run --spec serving_storm.json:\n")
    say(spec.to_json())
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
