"""Write ``src/repro_torch/bench/jax_starts.npz``: the multi-starts the
committed ``BENCH_{fig4,fig10,tuner,fig7_8,fig9,fig19,fig6,tab5,api,
online,memory,scenarios}.json`` were made from.

The JAX suites draw their Adam starts with
``repro.core.designs.random_inits(jax.random.PRNGKey(seed), n, design)``.
The committed files were made under JAX's former PRNG
(``jax_threefry_partitionable=False``; the installed JAX defaults to
True and draws other starts from the same key).  The port cannot import
JAX, so it reads these draws as data (``repro_torch.bench.common``):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_starts.py

``tests/test_torch_suites.py`` checks that the file holds these draws.
"""

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "bench" / "jax_starts.npz"

#: (n_params, n_starts, seed) of every Adam tuning the suites run: fig4's
#: 2-, 3-, 4- and 26-parameter designs; CLASSIC at 64 starts (fig4's
#: 2-parameter designs, fig10, the tuner's classic row) and K-LSM's seeds
#: 0-3 (the tuner's stability row); seed 1 for the tuner's throughput row
#: and its Fig. 6 grid (32 starts, the seed-style cells too).  The API
#: suites: fig7_8 and fig9 tune CLASSIC at 64 starts, fig19 CLASSIC, lazy
#: leveling (2 parameters), Dostoevsky (3) and Fluid (4) at 64 and K-LSM
#: (26) at 192, all from seed 0; fig6, tab5 and online's first tunings
#: CLASSIC at 64 from seed 0; the api suite CLASSIC and lazy leveling at 16
#: from seed 0; every re-tune storm of the drift loop (its oracle's and the
#: online arm's) CLASSIC at 32 from seed 0, and of the scenarios suite's
#: drift loops CLASSIC at 16 from seed 0
DRAWS = [(2, 64, 0), (3, 64, 0), (4, 64, 0), (26, 192, 0),
         (26, 128, 0), (26, 128, 1), (26, 128, 2), (26, 128, 3),
         (2, 64, 1), (2, 32, 1), (2, 16, 0), (2, 32, 0)]


def draws() -> dict:
    import jax

    from repro_torch.bench.common import starts_key
    with jax.threefry_partitionable(False):
        return {starts_key(p, n, seed): np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), (n, p), minval=-3.0, maxval=3.0),
            np.float32) for p, n, seed in DRAWS}


if __name__ == "__main__":
    np.savez(OUT, **draws())
    print(f"wrote {OUT}")
