"""The expert-parallel MoE of the datacenter step's mesh
(:func:`repro_torch.models.moe.moe_ep`), in process.

The reference's ``moe_ep`` runs once in a subprocess on 4 forced host
devices, on Auto-axes meshes, under ``jax.jit``
(``torch_moe_ep_cases.jax_results``, shared with the spawned ranks'
tests of ``test_torch_train_mesh.py`` and ``test_torch_mesh_axes.py``,
which hold the port's ``moe_ep`` on (2, 2), (1, 2) and (2, 1) gloo
ranks to it).  Here:

* ``moe_ep_plain`` (every (data, model) token slab dispatched at its own
  capacity, in one process) equals the reference's sharded ``moe_ep``,
  forward and gradients, on every case: capacity factor 1.0 (drops) and
  8 (none), a shared expert, and shapes that take the global view;
* ``moe_ffn``'s dispatch rule is the reference's;
* the whole-block fallback perturbs each slab leaf of a block at its
  global counters (one K1 call), the slab of the unsharded perturbation
  bit for bit, on the MoE and attention leaves of qwen3-moe's block;
* ``lm_api`` takes the MoE family on data and model axes;
* Adafactor's factored statistics are placed as their leaf without the
  dim each averages.
"""
import numpy as np
import pytest
import torch

import torch_moe_ep_cases as MC
import torch_train_mesh_ranks as RANKS
from repro_torch.configs.registry import get_config
from repro_torch.core import protocols as P
from repro_torch.distributed import sharding as S
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path, tree_map


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    return MC.jax_results(tmp_path_factory)


@pytest.mark.parametrize("case", list(MC.CASES))
def test_moe_ep_plain_matches_jax_sharded_moe_ep(jax_moe, case):
    (nd, nm), cf, shared, _ = MC.CASES[case]
    cfg = RANKS.moe_config(cf, shared)
    params, x, w = MC.inputs(case)
    p = tree_map(lambda a: torch.as_tensor(a).requires_grad_(True), params)
    tx = torch.as_tensor(x).requires_grad_(True)
    with M.recording_drops() as drops:
        y = M.moe_ep_plain(p, tx, cfg, nd, nm)
    leaves = tree_leaves_with_path(p)
    grads = torch.autograd.grad(torch.sum(y * torch.as_tensor(w)),
                                [tx] + [t for _, t in leaves])
    np.testing.assert_allclose(y.detach().numpy(), jax_moe[f"{case}|out"],
                               **MC.TOL)
    np.testing.assert_allclose(grads[0].numpy(), jax_moe[f"{case}|grad|x"],
                               **MC.TOL)
    for (path, _), g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), jax_moe[f"{case}|grad|{path}"],
                                   err_msg=path, **MC.TOL)
    if case in MC.DROPS:
        assert sum(drops) > 0
    if case in MC.NO_DROPS:
        assert sum(drops) == 0


def test_per_slab_capacity_is_not_the_global_view():
    """With drops, the slabs' capacity changes the output: moe_ep_plain
    on (1, 2) is not moe_xla (the reference's sharded moe_ep differs from
    its moe_xla the same way); without drops it is."""
    for cf, same in ((1.0, False), (8.0, True)):
        cfg = RANKS.moe_config(cf, 0)
        params, x, _ = MC.inputs("1x2_cf1")
        p = tree_map(torch.as_tensor, params)
        a = M.moe_ep_plain(p, torch.as_tensor(x), cfg, 1, 2)
        b = M.moe_xla(p, torch.as_tensor(x), cfg)
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5) == same, cf


def test_moe_ffn_dispatch_rule(monkeypatch):
    """``moe_ep`` under rules with a mesh, a decode step's single token a
    row too (its global view gathers the rank's expert slabs, as the
    reference's ``moe_xla`` under the rules reads them whole);
    ``moe_xla`` without a mesh."""
    cfg = RANKS.moe_config(1.0, 0)
    params, x, _ = MC.inputs("1x2_cf1")
    p, tx = tree_map(torch.as_tensor, params), torch.as_tensor(x)
    calls = []
    monkeypatch.setattr(M, "moe_ep", lambda *a: calls.append(a) or a[1])
    rules = S.AxisRules(mesh=Mesh({"data": 1, "model": 2},
                                  coords={"data": 0, "model": 0}))
    for r, xs, n in ((None, tx, 0), (S.AxisRules(), tx, 0),
                     (rules, tx[:, :1], 1), (rules, tx, 1)):
        before = len(calls)
        out = M.moe_ffn(p, xs, cfg, r)
        assert len(calls) - before == n
        if not n:
            assert torch.equal(out, M.moe_xla(p, xs, cfg))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_block_fallback_perturbs_slabs_at_global_counters(monkeypatch,
                                                          mesh):
    """One rep of qwen3-moe's stacked client block: ``perturb_tree`` with
    the block's placements (``transformer._block_places``) on each rank
    coordinate equals that rank's slab of the whole block's perturbation
    bit for bit, in one K1 call; the router, expert and attention leaves
    are slabs."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    spec = cfg.layer_specs()[0]
    stacked = T.init_lm(cfg, device="cpu")["client"]["layers"][0][0]
    seeds = O.leaf_seed_tree(stacked, 1234)
    rep = 1
    block = tree_map(lambda t: t[rep], stacked)
    whole = O.perturb_tree(block, seeds, 1e-2, rep)
    calls = []
    tree_fn = ZM.zo_noise_tree
    monkeypatch.setattr(ZM, "zo_noise_tree",
                        lambda *a, **k: calls.append(1) or tree_fn(*a, **k))
    nd, nm = mesh
    for d in range(nd):
        for m in range(nm):
            rules = S.AxisRules(mesh=Mesh({"data": nd, "model": nm},
                                          coords={"data": d, "model": m}),
                                enable_fsdp=False)
            places = T._block_places(block, spec, cfg, rules)
            cut = [p for p, pl in tree_leaves_with_path(places)
                   if pl.sharded]
            assert {"moe/router", "moe/up", "attn/wq/w", "attn/wo/w"} <= \
                set(cut)
            slabs = tree_map(S.shard, block, places)
            before = len(calls)
            got = O.perturb_tree(slabs, seeds, 1e-2, rep, places=places)
            assert len(calls) - before == 1
            want = tree_map(S.shard, whole, places)
            for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                         tree_leaves_with_path(want)):
                assert torch.equal(a, b), (mesh, d, m, path)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_lm_api_takes_moe_on_the_mesh(arch, mesh):
    rules = S.AxisRules(mesh=Mesh({"data": mesh[0], "model": mesh[1]},
                                  coords={"data": 0, "model": 0}),
                        enable_fsdp=False)
    api = P.lm_api(get_config(arch, smoke=True), rules)
    assert api.rules is rules and api.shardings is not None


def test_adafactor_statistics_are_placed_without_their_dim():
    """``train_state_shardings`` of an Adafactor state on (2, 2): a
    column-cut wq's ``vr`` (its mean over the columns) is whole and its
    ``vc`` the column slab; a stacked expert leaf cut on its experts
    keeps the cut on both; the AdamW moments keep the leaf's."""
    cfg = get_config("kimi-k2-1t-a32b", smoke=True)
    rules = S.AxisRules(mesh=Mesh({"data": 2, "model": 2},
                                  coords={"data": 1, "model": 1}),
                        enable_fsdp=False)
    api = P.lm_api(cfg, rules)
    params = T.init_lm(cfg, device="cpu")
    state = P.init_train_state(np.array([0, 1], np.uint32), params,
                               OPT.zo_sgd(1e-3), OPT.adafactor(1e-4),
                               shardings=api.shardings)
    places = P.train_state_shardings(state, api.shardings)
    srv = places["opt_server"]["v"]["layers"][0][0]
    wq = places["params"]["server"]["layers"][0][0]["attn"]["wq"]["w"]
    assert wq.dim_axes(2) == ("model",)
    assert srv["attn"]["wq"]["w"]["vr"] is not None
    assert not srv["attn"]["wq"]["w"]["vr"].sharded
    assert srv["attn"]["wq"]["w"]["vc"] == wq.drop(1)
    up = places["params"]["server"]["layers"][0][0]["moe"]["up"]
    assert up.dim_axes(1) == ("model",)
    assert srv["moe"]["up"]["vr"] == up.drop(-1)
    assert srv["moe"]["up"]["vc"] == up.drop(-2)
    assert srv["moe"]["up"]["vr"].sharded and srv["moe"]["up"]["vc"].sharded
    pl = dict(tree_leaves_with_path(places["opt_server"]["v"]))
    for k, v in tree_leaves_with_path(state["opt_server"]["v"]):
        want = v.shape if pl.get(k) is None else pl[k].local_shape
        assert tuple(v.shape) == tuple(want), k
    adam = P.init_train_state(np.array([0, 1], np.uint32), params,
                              OPT.zo_sgd(1e-3), OPT.adamw(1e-4),
                              shardings=api.shardings)
    ap = P.train_state_shardings(adam, api.shardings)
    assert ap["opt_server"]["m"] == places["params"]["server"]


def test_placement_drop():
    rules = S.AxisRules(mesh=Mesh({"data": 2, "model": 2},
                                  coords={"data": 0, "model": 1}),
                        enable_fsdp=False)
    pl = rules.sharding_for((3, 8, 64, 16),
                            ("layers", "experts", "d_model", "expert_ff"))
    assert pl.bounds == ((0, 3), (4, 8), (0, 64), (0, 16))
    d = pl.drop(-1)
    assert (d.spec, d.shape, d.bounds) == ((None, "model", None),
                                           (3, 8, 64), ((0, 3), (4, 8),
                                                        (0, 64)))
    assert not pl.drop(1).sharded
