"""The port's sharding rules (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against :mod:`repro.distributed.
sharding`: every case of ``tests/test_sharding.py`` on the port, and a
grid of shapes x logical names x shape-only meshes whose specs equal the
reference's PartitionSpecs as tuples.  No process group: the rules read
a mesh only through its named sizes (the reference's ``AxisRules`` reads
``mesh.shape`` alone too, so it takes the same shape-only mesh)."""
import itertools

import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.distributed import sharding as JS
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M

MESHES = {"data2_model4": {"data": 2, "model": 4},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
          "clients3": {"clients": 3}}
SHAPES = [(12, 64), (16, 48), (6, 3), (32, 8)]
LOGICAL = [("batch", "d_ff"), ("heads", "head_dim"), ("fsdp", "vocab"),
           ("clients", None), ("seq_shard", "seq_model"),
           ("experts", "expert_ff"), ("batch", "seq_shard"),
           ("kv_heads", "lru"), (None, "unknown_name")]


@pytest.fixture
def mesh():
    return M.Mesh({"data": 1, "model": 1})


def test_resolve_basic(mesh):
    assert S.AxisRules(mesh=mesh).resolve(("batch", None, "d_ff")) == \
        ("data", None, "model")


def test_divisibility_fallback(mesh):
    # axis size 1 => never sharded (size > 1 required)
    assert S.AxisRules(mesh=mesh).spec_for((12, 64), ("heads", "d_ff")) == \
        (None, None)


def test_axis_dedup(mesh):
    spec = S.AxisRules(mesh=mesh).resolve(("batch", "seq_shard", None))
    assert spec == ("data", None, None)


def test_fsdp_toggle(mesh):
    assert S.AxisRules(mesh=mesh, enable_fsdp=False).resolve(
        ("fsdp", "d_ff")) == (None, "model")
    assert S.AxisRules(mesh=mesh).resolve(("fsdp", "d_ff")) == \
        ("data", "model")


def test_with_updates(mesh):
    rules = S.AxisRules(mesh=mesh).with_updates(d_model=S.DATA_AXES)
    assert rules.rules["d_model"] == S.DATA_AXES
    assert S.AxisRules(mesh=mesh).rules["d_model"] == ()


def test_clients_rule_maps_to_data_axes(mesh):
    assert S.DEFAULT_RULES["clients"] == S.DATA_AXES
    rules = S.AxisRules(mesh=mesh)
    assert rules.resolve(("clients",)) == ("data",)
    assert rules.spec_for((8,), ("clients",)) == (None,)


def test_rules_tables_equal_the_reference():
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES
    assert (S.DATA_AXES, S.MODEL_AXIS) == (JS.DATA_AXES, JS.MODEL_AXIS)


def _tuple(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("name", list(MESHES))
def test_specs_equal_the_reference(name, fsdp):
    """resolve and spec_for over SHAPES x LOGICAL (and the same with the
    d_model rule sent to the data axes) on one shape-only mesh."""
    mesh = M.Mesh(MESHES[name])
    for upd in ({}, {"d_model": S.DATA_AXES}):
        ours = S.AxisRules(mesh=mesh, enable_fsdp=fsdp).with_updates(**upd)
        ref = JS.AxisRules(mesh=mesh, enable_fsdp=fsdp).with_updates(**upd)
        for logical in LOGICAL + [("d_model", "batch")]:
            want = ref.resolve(logical)
            assert isinstance(want, JP)
            assert ours.resolve(logical) == _tuple(want), logical
            for shape in SHAPES:
                assert ours.spec_for(shape, logical) == \
                    _tuple(ref.spec_for(shape, logical)), (shape, logical)
    for axes in itertools.chain.from_iterable(
            itertools.combinations(("pod", "data", "model", "clients", "x"),
                                   k) for k in range(4)):
        assert S.mesh_axis_size(mesh, *axes) == JS.mesh_axis_size(mesh,
                                                                  *axes)
    assert S.mesh_axis_size(None, "data") == JS.mesh_axis_size(None,
                                                               "data") == 1


def test_no_mesh_replicates():
    rules = S.AxisRules()
    assert rules.resolve(("batch", "d_ff")) == (None, None)
    assert rules.spec_for((4, 4), ("batch", "d_ff")) == \
        _tuple(JS.AxisRules().spec_for((4, 4), ("batch", "d_ff")))


def test_mesh_helpers_shapes():
    prod = M.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and not prod.groups
    assert tuple(prod.shape) == ("data", "model")
    multi = M.make_production_mesh(multi_pod=True)
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    with pytest.raises(ValueError, match="no process group"):
        prod.group("data")
    with pytest.raises(ValueError, match="not in mesh"):
        M.Mesh({"data": 2}, {"model": None})
    assert M.make_local_mesh().shape == {"data": 1, "model": 1}
    # one device: a model axis of 2 does not divide it and falls back
    one = M.make_local_mesh(2)
    assert one.shape == {"data": 1, "model": 1} and not one.groups
    # the rules resolve the production mesh as the reference's 16x16 mesh
    rules = S.AxisRules(mesh=prod)
    assert rules.spec_for((48, 4096), ("batch", "d_ff")) == ("data", "model")
    assert rules.spec_for((12, 64), ("heads", "head_dim")) == (None, None)


def test_one_rank_replay_mesh():
    """``make_replay_mesh`` raises when no process group is running and
    starts none; ``init_distributed`` starts a one-rank gloo group on an
    in-memory store, and the replay mesh's axis is that group's."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_replay_mesh()
    assert not dist.is_initialized()
    assert M.init_distributed("cpu")
    try:
        assert not M.init_distributed("cpu")
        mesh = M.make_replay_mesh()
        assert mesh.shape == {"clients": 1}
        assert dist.get_backend() == "gloo"
        assert mesh.rank("clients") == 0
        other = M.make_replay_mesh(axis="data")
        assert other.shape == {"data": 1}
        with pytest.raises(ValueError, match="outside"):
            M.make_replay_mesh(2)
    finally:
        dist.destroy_process_group()
