"""The port's cut planner (:mod:`repro_torch.fed.cutplan`): the client
loss's FLOPs counted on the ``meta`` device equal an analytic count of
its products at every gpt2-tiny cut, costs grow with depth on gpt2-tiny
and on the small CNN, and ``round_time_s`` / ``plan_cut`` /
``plan_fleet`` give the reference's answers on the reference's own
``CutCost`` list (compiled-HLO costs)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import GaussianMixtureImages as JGMM
from repro.fed import cutplan as JCP
from repro.models import cnn as JCNN
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.fed import cutplan as CP
from repro_torch.models import cnn as CNN

CNN_KW = dict(widths=(8, 16), blocks_per_stage=2, classes=4,
              client_blocks=1)
B, S = 2, 16


def _lm_batch():
    z = torch.zeros((B, S), dtype=torch.int64)
    return {"inputs": z, "labels": z}


def _analytic_flops(cfg, cut):
    """2·M·K·N per product of gpt2-tiny's client loss: per block the q k
    v o and MLP projections and the attention's two products (one
    16 x 16 tile, q_chunk = kv_chunk = S), the cut's blocks and the aux
    head's, and the tied unembedding over the padded vocab."""
    T, d, H = B * S, cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    block = (4 * 2 * T * d * d + 2 * 2 * T * d * cfg.d_ff
             + 2 * 2 * B * H * S * S * hd)
    return (cut + cfg.aux_layers) * block + 2 * T * d * cfg.vocab_padded


@pytest.fixture(scope="module")
def lm_costs():
    return CP.candidate_costs(gpt2_tiny(), _lm_batch())


def test_lm_flops_equal_analytic_count(lm_costs):
    cfg = gpt2_tiny()
    assert [c.cut for c in lm_costs] == CP.cut_candidates(cfg) == [1, 2, 3]
    for c in lm_costs:
        assert c.flops == _analytic_flops(cfg, c.cut)


def test_lm_costs_grow_with_depth(lm_costs):
    for field in ("flops", "bytes", "param_bytes"):
        v = [getattr(c, field) for c in lm_costs]
        assert all(a < b for a, b in zip(v, v[1:])), field


def test_cnn_costs_grow_with_depth():
    cfg = CNN.CNNConfig(**CNN_KW)
    batch = {"inputs": torch.zeros((8, 8, 8, 3)),
             "labels": torch.zeros((8,), dtype=torch.int64)}
    costs = CP.candidate_costs(cfg, batch)
    assert [c.cut for c in costs] == [1, 2, 3]
    pb = [c.param_bytes for c in costs]
    fl = [c.flops for c in costs]
    by = [c.bytes for c in costs]
    assert all(a < b for a, b in zip(pb, pb[1:]))
    assert all(a < b for a, b in zip(by, by[1:]))
    assert all(a <= b for a, b in zip(fl, fl[1:]))
    # the same client parameter bytes as the reference counts
    jcfg = JCNN.CNNConfig(**CNN_KW)
    jcosts = JCP.candidate_costs(jcfg, JGMM(classes=4, hw=8).batch(
        jax.random.PRNGKey(2), 8))
    assert pb == [c.param_bytes for c in jcosts]


@pytest.fixture(scope="module")
def jax_costs():
    """The reference's own CutCost list (compiled HLO) of its CNN test,
    and the same list as the port's CutCost."""
    jcosts = JCP.candidate_costs(JCNN.CNNConfig(**CNN_KW), JGMM(
        classes=4, hw=8, noise=0.5).batch(jax.random.PRNGKey(2), 8))
    return jcosts, [CP.CutCost(**dataclasses.asdict(c)) for c in jcosts]


def _profile_pairs(jcosts):
    slow_deadline = JCP.round_time_s(jcosts[0], JCP.DeviceProfile(
        "slow", 1e6, 1e6, 1e12), 2, 2) * 1.5
    specs = [("rich", 1e12, 1e11, 1e12, np.inf),
             ("tight", 1e12, 1e11, float(jcosts[0].param_bytes), np.inf),
             ("slow", 1e6, 1e6, 1e12, slow_deadline),
             ("broke", 1e12, 1e11, 1.0, np.inf)]
    return ([JCP.DeviceProfile(*s) for s in specs] +
            list(JCP.PROFILES.values()),
            [CP.DeviceProfile(*s) for s in specs] +
            list(CP.PROFILES.values()))


def test_plans_equal_jax_on_its_costs(jax_costs):
    jcosts, costs = jax_costs
    jprofs, profs = _profile_pairs(jcosts)
    for h, n_pairs in ((1, 1), (2, 2), (4, 3)):
        for jc, c in zip(jcosts, costs):
            for jp, p in zip(jprofs, profs):
                assert CP.round_time_s(c, p, h, n_pairs) == \
                    JCP.round_time_s(jc, jp, h, n_pairs)
        got = CP.plan_fleet(costs, profs, h, n_pairs)
        want = JCP.plan_fleet(jcosts, jprofs, h, n_pairs)
        assert [dataclasses.astuple(g) for g in got] == \
            [dataclasses.astuple(w) for w in want]


def test_cutplan_picks_deepest_feasible(jax_costs):
    _, costs = jax_costs
    _, (rich, tight, slow, broke, *_) = _profile_pairs(jax_costs[0])
    plan = CP.plan_cut(costs, rich, h=2, n_pairs=2)
    assert plan.cut == 3 and plan.feasible
    plan = CP.plan_cut(costs, tight, h=2, n_pairs=2)
    assert plan.cut == 1 and plan.feasible
    assert CP.plan_cut(costs, slow, h=2, n_pairs=2).cut < 3
    plan = CP.plan_cut(costs, broke, h=2, n_pairs=2)
    assert plan.cut == 1 and not plan.feasible


def test_profiles_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in CP.PROFILES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JCP.PROFILES.items()}
