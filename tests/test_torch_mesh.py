"""The port's mesh tier against the JAX package's: meshes, the sharding
rules, the logical hints, the shapes and input specs, and the roofline's
analytic terms.

The JAX package's specs come from one subprocess
(``tests/torch_mesh_oracle.py``, 512 host placeholder devices, ``Auto``
mesh axes); the port's are computed on ``DeviceMesh``es over a ``fake``
process group, which a fixture destroys after each use.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.launch.dryrun import _make_mesh, mesh_layout
from repro_torch.models.model import input_specs, param_specs
from repro_torch.utils import roofline, shard_hints
from repro_torch.utils.trace_costs import ring_bytes

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ("single", "multipod", "32x8", "1x1")


def _oracle(mode, tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / f"{mode}.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, os.path.join(HERE, "torch_mesh_oracle.py"),
                    mode, str(out)], check=True, env=env, timeout=600)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    return _oracle("specs", tmp_path_factory)


@pytest.fixture(scope="module")
def ref_hints(tmp_path_factory):
    return _oracle("hints", tmp_path_factory)


@pytest.fixture(scope="module")
def port_params():
    return {name: param_specs(cfg) for name, cfg in ARCHS.items()}


class _Mesh:
    """A fake process group of the mesh's world size and the mesh on it;
    the group is destroyed on exit."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        dims, _ = mesh_layout(self.kind)
        self.pg = mesh_mod.fake_process_group(int(torch.tensor(dims).prod()))
        self.pg.__enter__()
        return _make_mesh(self.kind)

    def __exit__(self, *exc):
        self.pg.__exit__(*exc)


def _norm(spec):
    """A port spec as the oracle's JSON lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_shapes_and_applicability_match_the_reference():
    from repro.configs import ARCHS as RA
    from repro.configs import SHAPES as RS
    from repro.configs import shape_applicable as rsa
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in RS.items()}
    for name in ARCHS:
        for sname in SHAPES:
            assert shape_applicable(ARCHS[name], SHAPES[sname]) == \
                rsa(RA[name], RS[sname]), (name, sname)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_input_specs_match_the_reference(arch, port_params):
    """``param_specs`` (through ``convert.py``'s layout) and
    ``input_specs`` agree with the JAX package's ``eval_shape`` stand-ins
    in shape and dtype."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as RA
    from repro.configs import SHAPES as RS
    from repro.models import build_model

    from repro_torch.convert import lm_params_to_reference
    from repro_torch.utils.tree import leaves_with_path
    cfg = ARCHS[arch]
    api = build_model(RA[arch])
    ref = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
           for p, x in jax.tree_util.tree_flatten_with_path(
               api.param_specs())[0]}
    tree = lm_params_to_reference(cfg, port_params[arch])
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in leaves_with_path(tree)}
    assert got == ref

    def dt(x):
        return str(x.dtype).replace("torch.", "")
    for sname, shape in SHAPES.items():
        rin = api.input_specs(RS[sname])
        pin = input_specs(cfg, shape)
        if shape.kind != "decode":
            assert {k: (tuple(v.shape), dt(v)) for k, v in pin.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in rin.items()}
            continue
        assert tuple(pin["tokens"].shape) == tuple(rin["tokens"].shape)
        assert dt(pin["tokens"]) == str(rin["tokens"].dtype)
        assert pin["pos"].shape == () and pin["pos"].dtype == torch.int32
        assert rin["pos"].dtype == jnp.int32
        # the cache: every leaf at its place in the reference's tree
        for (path, leaf) in sharding.leaf_paths(pin["cache"]):
            ref_path, stacked = sharding.reference_cache_path(path, cfg)
            node = rin["cache"]
            for k in ref_path:
                node = node[k]
            want = tuple(node.shape[1:]) if stacked else tuple(node.shape)
            assert tuple(leaf.shape) == want, (path, ref_path)
            assert dt(leaf) == str(node.dtype)


@pytest.mark.parametrize("mesh_kind", MESHES)
def test_sharding_rules_are_the_reference_s(mesh_kind, ref_specs,
                                            port_params):
    """``param_spec`` on every leaf of the ten archs at full size, the
    port's ``param_shardings`` on its own per-layer tree, and
    ``batch_shardings``/``cache_shardings`` of every applicable cell equal
    the JAX package's exactly."""
    ref = ref_specs[mesh_kind]
    with _Mesh(mesh_kind) as mesh:
        for arch, cfg in sorted(ARCHS.items()):
            rec = ref[arch]
            for path, shape, spec in rec["params"]:
                got = sharding.param_spec(tuple(path), tuple(shape), cfg,
                                          mesh)
                assert _norm(got) == spec, (arch, path)
            # the port's own tree: every leaf maps to a reference leaf
            want = {tuple(p): s for p, _, s in rec["params"]}
            shard_tree = sharding.param_shardings(port_params[arch], cfg,
                                                  mesh)
            for path, ns in sharding.leaf_paths(shard_tree):
                rpath, stacked = sharding.reference_param_path(path, cfg)
                spec = want[rpath]
                assert _norm(ns.spec) == (spec[1:] if stacked else spec), \
                    (arch, path)
            for sname, shape in SHAPES.items():
                if not shape_applicable(cfg, shape)[0]:
                    continue
                ins = input_specs(cfg, shape)
                if shape.kind != "decode":
                    got = {k: _norm(v.spec) for k, v in
                           sharding.batch_shardings(ins, cfg, mesh,
                                                    shape).items()}
                    assert got == rec["batch"][sname], (arch, sname)
                    continue
                cwant = {tuple(p): s for p, _, s in rec["cache"][sname]}
                for path, ns in sharding.leaf_paths(sharding.cache_shardings(
                        ins["cache"], cfg, mesh, shape)):
                    rpath, stacked = sharding.reference_cache_path(path, cfg)
                    spec = cwant[rpath]
                    assert _norm(ns.spec) == (spec[1:] if stacked
                                              else spec), (arch, sname, path)


def test_placements_name_every_mesh_dimension_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    with _Mesh("multipod") as mesh:
        assert sharding.placements((("pod", "data"), None, "model"),
                                   mesh) == (Shard(0), Shard(0), Shard(2))
        assert sharding.placements((None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        assert mesh_mod.data_axes(mesh) == ("pod", "data")
        assert mesh_mod.axis_size(mesh, "model") == 16
        assert mesh_mod.axis_size(mesh, "expert") == 1
    assert not torch.distributed.is_initialized()


def test_hint_resolves_the_reference_s_axes(ref_hints):
    """The axes a hint resolves on each mesh, under the default and the
    decode rules (the duplicate-axis and divisibility drops included),
    are the output shardings of the JAX package's lowered hint."""
    for (shape, logical, mesh_kind, rules), want in zip(ref_hints["cases"],
                                                        ref_hints["specs"]):
        over = {None: {}, "decode": shard_hints.decode_rules(False),
                "decode_sp": shard_hints.decode_rules(True)}[rules]
        with _Mesh(mesh_kind) as mesh, shard_hints.logical_axis_rules(over):
            got = shard_hints.resolve(tuple(shape), tuple(logical), mesh)
            # a compiled sharding names no axis of size 1
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            got = [e if e is None or not isinstance(e, str)
                   or sizes[e] > 1 else None for e in got]
        assert _norm(got) == want, (shape, logical, mesh_kind, rules)


def test_hint_redistributes_a_dtensor_and_its_gradient():
    """Inside a mesh context a hint moves a DTensor to the resolved
    placements, and its gradient to the same; outside one it is the
    identity."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = torch.ones(4, 8)
    assert shard_hints.hint(x, "batch", "mlp") is x
    with _Mesh("2x2") as mesh, FakeTensorMode():
        t = DTensor.from_local(torch.empty(2, 8), mesh,
                               [Shard(0), Replicate()], run_check=False)
        t.requires_grad_(True)
        with shard_hints.mesh_context(mesh):
            y = shard_hints.hint(t, "batch", "mlp")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            g = DTensor.from_local(torch.empty(2, 8), mesh,
                                   [Shard(0), Partial()], run_check=False)
            (gx,) = torch.autograd.grad(y, t, g)
        # the cotangent takes the constraint, as JAX transposes
        # with_sharding_constraint: the partial sum is reduce-scattered
        assert tuple(gx.placements) == (Shard(0), Shard(1))


def test_model_flops_equal_the_reference_s():
    from repro.configs import ARCHS as RA
    from repro.configs import SHAPES as RS
    from repro.utils import roofline as rr
    for name in ARCHS:
        for sname in SHAPES:
            assert roofline.model_flops(ARCHS[name], SHAPES[sname]) == \
                rr.model_flops(RA[name], RS[sname]), (name, sname)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_bytes_are_the_reference_s(op):
    from repro.utils import hlo
    inst = hlo.Instruction(name="x", op=op, type_str="bf16[64,1024]",
                           operands=[], line="")
    for group in range(1, 17):
        assert ring_bytes(op, 64 * 1024 * 2, group) == \
            hlo._ring_bytes(op, inst, {}, group), (op, group)


def test_axis_bandwidth_charges_nvlink_inside_a_node():
    assert roofline.axis_bandwidths((2, 2), ("data", "model")) == \
        {"data": roofline.NVLINK_BW, "model": roofline.NVLINK_BW}
    assert roofline.axis_bandwidths((16, 16), ("data", "model")) == \
        {"data": roofline.NIC_BW, "model": roofline.NIC_BW}
    assert roofline.axis_bandwidths((32, 8), ("data", "model")) == \
        {"data": roofline.NIC_BW, "model": roofline.NVLINK_BW}
    assert roofline.axis_bandwidths((2, 16, 16), ("pod", "data", "model"))[
        "pod"] == roofline.NIC_BW


def test_host_and_problem_meshes_cover_the_running_group():
    """On a host without a group, the host and problem meshes start a
    one-rank one (gloo on the CPU): a (1, 1) ("data", "model") mesh and a
    1-D ("problem",) one."""
    import torch.distributed as dist
    try:
        host = mesh_mod.make_host_mesh(device_type="cpu")
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (1, 1)
        prob = mesh_mod.make_problem_mesh(device_type="cpu")
        assert prob.mesh_dim_names == ("problem",)
        assert tuple(prob.shape) == (1,)
        assert mesh_mod.data_axes(host) == ("data",)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="already running"):
        with mesh_mod.fake_process_group(4):
            with mesh_mod.fake_process_group(4):
                pass
    assert not dist.is_initialized()
