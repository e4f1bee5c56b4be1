"""The JAX package's mesh tier as JSON, for the port's parity tests.

Run in a subprocess of its own (``python tests/torch_mesh_oracle.py MODE
OUT.json``): ``main`` sets ``XLA_FLAGS`` for 512 host placeholder devices
before it imports ``jax``, as ``repro/launch/dryrun.py`` does, and builds
every mesh with ``Auto`` axes.  Importing the module (for its constants)
touches neither.  (``jax.make_mesh`` makes ``Explicit`` axes on
JAX 0.9.0, and ``with_sharding_constraint`` refuses those inside a jitted
step, so the unwrapped dry run records ``error`` for every cell.)

Modes:

* ``specs`` — ``param_spec`` of every leaf of the ten archs at full size
  (``ModelAPI.param_specs``), and ``batch_shardings``/``cache_shardings``
  of every applicable (arch x shape), on the meshes ``single``,
  ``multipod``, ``32x8`` and ``1x1``;
* ``hints`` — the spec of the output sharding of a lowered ``hint`` for
  each case of :data:`HINT_CASES`;
* ``dryrun`` — ``run_cell`` on the reduced ``qwen3-14b`` of
  :data:`REDUCED` on a ``2x2`` mesh at train, prefill and decode, with
  ``Auto`` axes; and the train cell once more without them (the fault).
"""

import json
import os
import sys

MESHES = ("single", "multipod", "32x8", "1x1")
REDUCED = {"num_layers": "2", "d_model": "256", "num_heads": "4",
           "num_kv_heads": "2", "head_dim": "64", "d_ff": "512",
           "vocab_size": "1024"}
# (mesh, shape, logical names, rule overrides: None | "decode" | "decode_sp")
HINT_CASES = [
    ("single", (256, 4096, 40, 128), ("batch", "seq", "heads", "head_dim"),
     None),
    ("single", (256, 4096, 32, 128), ("batch", "seq", "heads", "head_dim"),
     None),
    ("multipod", (256, 4096, 32, 128), ("batch", "seq", "heads",
                                        "head_dim"), None),
    ("multipod", (8, 4096, 5120), ("batch", "seq", "embed"), None),
    ("single", (8, 4096, 5120), ("batch", "seq", "embed"), None),
    # duplicate axis: heads takes model, kv_heads must drop it
    ("single", (256, 32, 16, 64), ("batch", "heads", "kv_heads",
                                   "head_dim"), None),
    ("single", (256, 4096, 13824), ("batch", "seq", "mlp"), None),
    ("single", (256, 4096, 151936), ("batch", "seq", "vocab"), None),
    ("single", (256, 8, 16, 5120), ("batch", "expert", "capacity",
                                    "embed"), None),
    ("single", (256, 8, 16, 14336), ("batch", "expert", "capacity",
                                     "expert_mlp"), None),
    ("single", (256, 64, 16, 1408), ("batch", "expert", "capacity",
                                     "expert_mlp"), None),
    ("single", (128, 32768, 8, 128), ("batch", "kv_seq", "heads",
                                      "head_dim"), "decode"),
    ("single", (1, 524288, 8, 128), ("batch", "kv_seq", "heads",
                                     "head_dim"), "decode_sp"),
    ("multipod", (1, 524288, 40, 128), ("batch", "kv_seq", "heads",
                                        "head_dim"), "decode_sp"),
    ("32x8", (256, 4096, 40, 128), ("batch", "seq", "heads", "head_dim"),
     None),
    ("1x1", (2, 16, 4, 64), ("batch", "seq", "heads", "head_dim"), None),
]


def _auto_axes(make_mesh):
    """``jax.make_mesh`` with ``Auto`` axes unless the caller names some."""
    from jax.sharding import AxisType

    def wrapped(shape, axes, **kw):
        kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
        return make_mesh(shape, axes, **kw)
    return wrapped


def spec_json(spec):
    """A PartitionSpec as a list: None, an axis name, or a list of names
    (a one-name tuple as the name)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


def _key(p):
    return getattr(p, "key", getattr(p, "idx", p))


def specs() -> dict:
    import jax
    from repro.configs import ARCHS, SHAPES, shape_applicable
    from repro.launch import dryrun, sharding
    from repro.models import build_model
    out = {}
    for mesh_kind in MESHES:
        mesh = dryrun._make_mesh(mesh_kind)
        per = {}
        for name, cfg in sorted(ARCHS.items()):
            api = build_model(cfg)
            leaves = jax.tree_util.tree_flatten_with_path(api.param_specs())[0]
            rec = {"params": [
                [[_key(p) for p in path], list(leaf.shape),
                 spec_json(sharding.param_spec(
                     tuple(_key(p) for p in path), leaf.shape, cfg, mesh))]
                for path, leaf in leaves], "batch": {}, "cache": {}}
            for sname, shape in SHAPES.items():
                if not shape_applicable(cfg, shape)[0]:
                    continue
                ins = api.input_specs(shape)
                if shape.kind == "decode":
                    sh = jax.tree_util.tree_leaves(sharding.cache_shardings(
                        ins["cache"], cfg, mesh, shape))
                    cl = jax.tree_util.tree_flatten_with_path(
                        ins["cache"])[0]
                    rec["cache"][sname] = [
                        [[_key(p) for p in path], list(leaf.shape),
                         spec_json(s.spec)]
                        for (path, leaf), s in zip(cl, sh)]
                else:
                    sh = sharding.batch_shardings(ins, cfg, mesh, shape)
                    rec["batch"][sname] = {k: spec_json(v.spec)
                                           for k, v in sh.items()}
            per[name] = rec
        out[mesh_kind] = per
    return out


def hints() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.launch import dryrun
    from repro.utils import shard_hints
    out = []
    for mesh_kind, shape, logical, rules in HINT_CASES:
        mesh = dryrun._make_mesh(mesh_kind)
        over = {None: {}, "decode": shard_hints.decode_rules(False),
                "decode_sp": shard_hints.decode_rules(True)}[rules]
        with mesh, shard_hints.logical_axis_rules(over):
            fn = jax.jit(lambda x: shard_hints.hint(x, *logical))
            comp = fn.lower(jax.ShapeDtypeStruct(shape, jnp.bfloat16)) \
                .compile()
            spec = comp.output_shardings.spec
        spec = spec_json(spec) + [None] * (len(shape) - len(spec))
        out.append(spec)
    return {"cases": [list(map(list, [c[1], c[2]])) + [c[0], c[3]]
                      for c in HINT_CASES], "specs": out}


def dryrun_cells(make_mesh) -> dict:
    import jax
    from repro.launch import dryrun
    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen3-14b", shape, "2x2", overrides=REDUCED,
                              save=False, verbose=False)
        out[shape] = {k: rec.get(k) for k in ("status", "error", "hlo")}
    # the fault: the same train cell on JAX's own (Explicit) axes
    jax.make_mesh = make_mesh
    rec = dryrun.run_cell("qwen3-14b", "train_4k", "2x2", overrides=REDUCED,
                          save=False, verbose=False)
    out["unwrapped_train_4k"] = {"status": rec["status"],
                                 "error": rec.get("error")}
    return out


def main() -> None:
    mode, path = sys.argv[1], sys.argv[2]
    # before jax is first imported: it fixes the device count then
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    import jax
    make_mesh = jax.make_mesh
    jax.make_mesh = _auto_axes(make_mesh)
    if mode == "dryrun":
        result = dryrun_cells(make_mesh)
    else:
        result = {"specs": specs, "hints": hints}[mode]()
    with open(path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
