"""The port's MoE FFN (:mod:`repro_torch.models.moe`) against the JAX
package's on the CPU, on qwen3-moe-30b-a3b's smoke config (8 experts,
top-2): the router (ties to the lower index, as ``lax.top_k``), the
capacity rule, ``moe_xla`` at a capacity that drops tokens and at one
that does not, ``moe_xla`` against the all-experts oracle at high
capacity, the shared-expert branch, the dispatch and a bf16 combine bit
for bit against the reference's (serial scatter-add order), and kernel
K1's noise on a stacked 4-D expert leaf bit for bit.  Inputs come from
numpy seeds, params from the JAX init through the bridge.  The
expert-parallel path is ``test_torch_moe_ep.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.qwen3_moe_30b_a3b import smoke_config as jax_smoke
from repro.distributed.sharding import AxisRules
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import MoECfg as JMoECfg
from repro_torch.bridge import from_jax
from repro_torch.configs.qwen3_moe_30b_a3b import smoke_config
from repro_torch.kernels import ops as O
from repro_torch.models import moe as M
from repro_torch.models.config import MoECfg

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
# f32 against XLA: the router's softmax and the expert products in other
# summation orders, a few ulps of the output's largest entry (measured
# up to 2 ulps; the expert leaves are drawn at 1/sqrt(n_experts), so
# |out| reaches ~10)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(cf=None, shared=0, dtype="float32", top_k=2):
    """The smoke configs with capacity factor ``cf``, ``shared`` shared
    experts and ``top_k``, in ``dtype``."""
    jcfg, cfg = jax_smoke(), smoke_config()
    m = dataclasses.asdict(cfg.moe)
    if cf is not None:
        m["capacity_factor"] = cf
    m["n_shared_experts"], m["top_k"] = shared, top_k
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jcfg, moe=JMoECfg(**m), **kw),
            cfg.replace(moe=MoECfg(**m), **kw))


def _params(jcfg):
    pb = JL.ParamBuilder(jax.random.PRNGKey(0), "init", jcfg.jnp_param_dtype())
    jp = jax.tree.map(np.asarray, JM.init_moe(pb, "moe", jcfg))
    return jp, from_jax(jp, device="cpu")


def _x(jcfg, B=3, S=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)


def _kept(gates_idx, T, cfg):
    """How many (token, choice) entries the capacity keeps."""
    idx = gates_idx[1].reshape(-1).numpy()
    C = M._capacity(T, cfg)
    return int(sum(min(C, int((idx == e).sum()))
                   for e in range(cfg.moe.n_experts)))


def test_route_matches_jax_and_breaks_ties_low():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x(jcfg).reshape(-1, jcfg.d_model)
    x[:4] = 0.0                 # zero rows: every expert's logit ties
    gj, ij = JM.route(jnp.asarray(jp["router"]), jnp.asarray(x), jcfg)
    gt, it = M.route(tp["router"], torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(it[:4].numpy(), [[0, 1]] * 4)


def test_capacity_matches_jax():
    for E, k, cf in ((8, 2, 2.0), (128, 8, 1.25), (384, 8, 1.25),
                     (8, 2, 0.3), (7, 3, 1.1)):
        jcfg, cfg = _cfgs()
        m = dict(n_experts=E, top_k=k, d_ff_expert=4, capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, moe=JMoECfg(**m))
        cfg = cfg.replace(moe=MoECfg(**m))
        for T in (1, 2, 5, 6, 8, 17, 48, 1024, 2048, 4096, 32768):
            assert M._capacity(T, cfg) == JM._capacity(T, jcfg), (E, T)


@pytest.mark.parametrize("cf,drops", [(0.5, True), (2.0, False)],
                         ids=["drops", "no-drop"])
def test_moe_xla_matches_jax(cf, drops):
    """48 tokens: at capacity factor 0.5 an expert keeps 8 of its
    entries (some expert gets more), at 2.0 it keeps 24 (none does)."""
    jcfg, cfg = _cfgs(cf)
    jp, tp = _params(jcfg)
    x = _x(jcfg)
    T = x.shape[0] * x.shape[1]
    kept = _kept(M.route(tp["router"], torch.as_tensor(x).reshape(T, -1),
                         cfg), T, cfg)
    assert (kept < T * cfg.moe.top_k) == drops
    ref = JM.moe_xla(jp, jnp.asarray(x), jcfg, RULES)
    got = M.moe_xla(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_moe_xla_equals_all_experts_oracle_at_high_capacity():
    """At a capacity no expert fills, the dispatch drops nothing: the
    port's moe_xla equals its all-experts combine, and both JAX's."""
    jcfg, cfg = _cfgs(8.0)
    jp, tp = _params(jcfg)
    x = torch.as_tensor(_x(jcfg))
    got = M.moe_xla(tp, x, cfg)
    oracle = M.moe_reference(tp, x, cfg)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(JM.moe_reference(jp, jnp.asarray(
            x.numpy()), jcfg)), **TOL)


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_shared_expert_branch_matches_jax(cf):
    """``n_shared_experts=1`` (kimi-style): a gated MLP of d_ff_expert on
    every token, added to the routed experts' output."""
    jcfg, cfg = _cfgs(cf, shared=1)
    jp, tp = _params(jcfg)
    assert "shared" in tp and set(tp["shared"]) == {"up", "gate", "down"}
    x = _x(jcfg, seed=2)
    ref = JM.moe_xla(jp, jnp.asarray(x), jcfg, RULES)
    got = M.moe_xla(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        M.moe_reference(tp, torch.as_tensor(x), cfg).numpy(),
        np.asarray(JM.moe_reference(jp, jnp.asarray(x), jcfg)), **TOL)


def _bf16(a):
    return np.asarray(a).astype(np.float32).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_dispatch_and_bf16_combine_bit_equal_to_jax(monkeypatch, cf):
    """``_dispatch_compute_combine`` in bf16 at top-4 with the expert FFN
    replaced on both sides by an exact map (y = 1.5 x, and 0 in empty
    slots): the dispatch (which entries each expert keeps, in which slot)
    and the combine equal the reference's bit for bit.  The combine adds
    each token's k contributions in ascending expert order from zero, as
    XLA:CPU applies the reference's serial scatter-add; the other order
    rounds differently on some entries (at k >= 3: two bf16 additions to
    zero commute)."""
    jcfg, cfg = _cfgs(cf, dtype="bfloat16", top_k=4)
    rng = np.random.default_rng(6)
    T, d, E, k = 40, jcfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    xf = _bf16(rng.standard_normal((T, d)))
    g = rng.uniform(0.05, 1.0, (T, k)).astype(np.float32)
    g = g / g.sum(-1, keepdims=True)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]
                   ).astype(np.int32)
    monkeypatch.setattr(JM, "_expert_ffn", lambda buf, *a: buf * jnp.asarray(
        1.5, buf.dtype))
    monkeypatch.setattr(M, "_expert_ffn", lambda buf, *a: buf * 1.5)
    ref = np.asarray(JM._dispatch_compute_combine(
        jnp.asarray(xf), jnp.asarray(g), jnp.asarray(idx), None, None, None,
        jcfg))
    tx = from_jax(xf, device="cpu")
    got = M._dispatch_compute_combine(
        tx, torch.as_tensor(g), torch.as_tensor(idx).long(), None, None,
        None, cfg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    # the same contributions added in descending expert order
    monkeypatch.setattr(torch, "argsort",
                        lambda t, dim=-1: torch.sort(t, dim=dim,
                                                     descending=True)[1])
    rev = M._dispatch_compute_combine(
        tx, torch.as_tensor(g), torch.as_tensor(idx).long(), None, None,
        None, cfg).float().numpy()
    assert not np.array_equal(rev, got)


def test_stacked_expert_leaf_noise_bit_equal_to_jax():
    """The client's stacked expert leaves, (reps, E, d, f): their seeds,
    the replay's whole-leaf field on the canonical 2-D view (reps*E*d,
    f), and each rep's theta + mu*U (the whole-block fallback's K1
    perturb, rep r at row offset r*E*d) equal JAX's bit for bit."""
    jcfg, cfg = jax_smoke(), smoke_config()
    cp = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(0),
                                             jcfg))["client"]
    tcp = from_jax(cp, device="cpu")
    seeds = O.leaf_seed_tree(tcp, -31337)
    jseeds = JO.leaf_seed_tree(cp, jnp.int32(-31337))
    u = O.kernel_direction_tree(tcp, seeds)
    ju = JO.kernel_direction_tree(cp, jseeds)
    moe, jmoe = tcp["layers"][0][0]["moe"], cp["layers"][0][0]["moe"]
    for name in ("up", "gate", "down"):
        leaf = moe[name]
        assert leaf.dim() == 4 and leaf.shape[0] == 2
        s = seeds["layers"][0][0]["moe"][name]
        assert s == int(jseeds["layers"][0][0]["moe"][name])
        np.testing.assert_array_equal(
            u["layers"][0][0]["moe"][name].numpy(),
            np.asarray(ju["layers"][0][0]["moe"][name]))
        for r in range(leaf.shape[0]):
            got = O.perturb_tree(leaf[r], s, 1e-2, r)
            want = JO.perturb_tree(jnp.asarray(jmoe[name][r]), jnp.int32(s),
                                   1e-2, r)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _analytic_flops(cfg, cut, B, S):
    """2*M*K*N per product of the MoE smoke config's client loss: per
    block the q / k / v / o projections, the attention's two products
    (one S x S tile: q_chunk = kv_chunk = S), the f32 router and the
    three expert products over E capacity buffers of C rows; and the
    aux head's unembedding (the client's table) over the padded vocab."""
    T, d, hd = B * S, cfg.d_model, cfg.resolved_head_dim
    H, K, m = cfg.n_heads, cfg.n_kv_heads, cfg.moe
    C = M._capacity(T, cfg)
    block = (2 * T * d * hd * (2 * H + 2 * K) + 2 * 2 * B * H * S * S * hd
             + 2 * T * d * m.n_experts
             + 3 * 2 * m.n_experts * C * d * m.d_ff_expert)
    return cut * block + 2 * T * d * cfg.vocab_padded


def test_cutplan_costs_on_meta_and_plans_equal_jax():
    """The cut planner on the MoE smoke config: the dispatch runs on the
    ``meta`` device; its FLOPs equal the analytic count at every cut, the
    client parameter bytes equal the reference's, and the reference's
    ``plan_fleet`` on the same costs gives the port's plans."""
    from repro.core.split import param_bytes as jax_param_bytes
    from repro.fed import cutplan as JCP
    from repro_torch.fed import cutplan as CP
    jcfg, cfg = jax_smoke(), smoke_config()
    B, S = 2, 16
    z = torch.zeros((B, S), dtype=torch.int64)
    costs = CP.candidate_costs(cfg, {"inputs": z, "labels": z})
    assert [c.cut for c in costs] == [1, 2, 3]
    for c in costs:
        assert c.flops == _analytic_flops(cfg, c.cut, B, S)
        jp = jax.eval_shape(lambda: JT.init_lm(
            jax.random.PRNGKey(0), dataclasses.replace(jcfg, cut_layers=c.cut)))
        assert c.param_bytes == jax_param_bytes(jp["client"])
    jcosts = [JCP.CutCost(**dataclasses.asdict(c)) for c in costs]
    slow = JCP.DeviceProfile("slow", 1e6, 1e6, 1e12, JCP.round_time_s(
        jcosts[1], JCP.DeviceProfile("x", 1e6, 1e6, 1e12), 2, 2) * 1.01)
    jprofs = list(JCP.PROFILES.values()) + [
        slow, JCP.DeviceProfile("tight", 1e12, 1e11,
                                float(costs[1].param_bytes))]
    profs = [CP.DeviceProfile(*dataclasses.astuple(p)) for p in jprofs]
    for h, n_pairs in ((1, 1), (2, 2)):
        got = CP.plan_fleet(costs, profs, h, n_pairs)
        want = JCP.plan_fleet(jcosts, jprofs, h, n_pairs)
        assert [dataclasses.astuple(g) for g in got] == \
            [dataclasses.astuple(w) for w in want]
    assert [p.cut for p in CP.plan_fleet(costs, profs[-2:], 2, 2)] == [2, 2]
