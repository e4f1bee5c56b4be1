"""Quickstart on the port: tune an LSM tree nominally and robustly, deploy
both on the engine, and run the write burst the robust tuning guards
against.  The five steps of ``examples/quickstart.py``, on the card:

    PYTHONPATH=src python -m repro_torch.quickstart             # the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

``main`` returns what it printed as a dict, so callers can check it.
"""

from __future__ import annotations

import argparse

import numpy as np

from .core import (LSMSystem, cost_vector, describe, rho_from_history,
                   tune_nominal, tune_robust)
from .lsm import LSMTree, populate, run_session

EXPECTED = np.array([0.33, 0.33, 0.33, 0.01])  # (z0, z1, q, w)
HISTORY = np.array([
    [0.40, 0.30, 0.25, 0.05],
    [0.20, 0.35, 0.35, 0.10],
    [0.10, 0.20, 0.15, 0.55],   # ... including one write burst
])
BURST = np.array([0.05, 0.10, 0.05, 0.80])


def main(device=None, n_starts: int = 32, steps: int = 150,
         n: int = 20_000, n_queries: int = 3000, starts=None,
         verbose: bool = True) -> dict:
    say = print if verbose else (lambda *a, **k: None)
    # 1. The workload you expect: read-heavy (ZippyDB-like).
    # 2. Historical traces imply an uncertainty radius rho (Algorithm 1).
    rho = rho_from_history(HISTORY)
    say(f"rho from history = {rho:.3f}")

    # 3. Tune.  (Paper defaults: 10B x 1KiB entries, 10 bits/entry memory.)
    sys_params = LSMSystem()
    nominal = tune_nominal(EXPECTED, sys_params, n_starts=n_starts,
                           steps=steps, device=device, starts=starts)
    robust = tune_robust(EXPECTED, rho, sys_params, n_starts=n_starts,
                         steps=steps, device=device, starts=starts)
    say(f"nominal tuning: {describe(nominal.phi, sys_params)} "
        f"expected C = {nominal.cost:.3f}")
    say(f"robust  tuning: {describe(robust.phi, sys_params)} "
        f"worst-case C = {robust.cost:.3f}")
    out = {"rho": rho, "tunings": {}}

    # 4. Model-predicted cost under the write burst the DBA feared, and
    # 5. both tunings deployed on the engine at reduced scale, executing
    #    the burst.  from_phi receives the SAME system the tuning was made
    #    under: it converts memory splits to bits-per-entry and re-scales
    #    them to the reduced key count.
    for name, r in [("nominal", nominal), ("robust", robust)]:
        c = float(BURST @ cost_vector(r.phi, sys_params).numpy())
        say(f"  {name}: model cost under write burst = {c:.3f}")
        tree = LSMTree.from_phi(r.phi, sys_params, expected_entries=n,
                                entry_bytes=64, device=device)
        keys = populate(tree, n, seed=1)
        res = run_session(tree, keys, BURST, n_queries=n_queries, seed=2)
        say(f"  {name}: engine-measured I/O/query under burst "
            f"= {res.avg_io_per_query:.3f}")
        out["tunings"][name] = {"result": r, "model_burst_cost": c,
                                "session": res}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
