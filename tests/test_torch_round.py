"""One HERON-SFL round of the port against :mod:`repro.core.protocols`
on gpt2-tiny: same params (through the bridge), same tokens, same round
seed and the same (all-ones) participation mask.  Also, inside the port:
the lean uplink equals the dense one at h=1, the seed-replay aggregate
matches the JAX one and ignores masked-out clients, and the replayed
directions are the JAX directions bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import aggregate as JAG
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.distributed.sharding import AxisRules
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import aggregate as AG
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
# The two frameworks sum in other orders, so the losses differ by a few
# f32 ulps.  A coefficient is (l_pert - l_clean) / mu, so the client step
# moves by lr * ulps / mu: mu=1e-2 and lr=1e-3 keep that under the param
# tolerance.  The server's first AdamW step is m/(sqrt(v)+eps) ~ g/|g|,
# which turns rounding in a near-zero gradient into an O(lr) change, so
# its lr is 1e-4.
MU, LR, SERVER_LR, N = 1e-2, 1e-3, 1e-4, 2
PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
KEY = jax.random.PRNGKey(9)


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), jax_gpt2_tiny())
    return jax.tree.map(np.asarray, p)


def _round_batch(h, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jax_gpt2_tiny().vocab, (N, h, b, s + 1))
    return {"inputs": toks[..., :-1], "labels": toks[..., 1:]}


def _jax_round(params, rb, h, uplink="seed_replay", probe="weights"):
    cfg = dataclasses.replace(jax_gpt2_tiny(), forward_impl="kernel",
                              attn_probe=probe)
    sopt = JOPT.adamw(SERVER_LR)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rnd = jax.jit(JP.make_fed_round(
        JP.lm_api(cfg, RULES), "heron", JZ.ZOConfig(mu=MU, n_pairs=1),
        JP.FedConfig(n_clients=N, h=h), JOPT.zo_sgd(LR), sopt,
        uplink=uplink, client_lr=LR))
    new, m = rnd(state, rb, KEY)
    return jax.tree.map(np.asarray, new), m


def _port_round(params, rb, h, uplink="seed_replay", probe="weights"):
    cfg = dataclasses.replace(gpt2_tiny(), forward_impl="kernel",
                              attn_probe=probe)
    sopt = OPT.adamw(SERVER_LR)
    tp = from_jax(params, device="cpu")
    state = {"client": tp["client"], "server": tp["server"],
             "opt_server": sopt.init(tp["server"])}
    rnd = P.make_fed_round(P.lm_api(cfg), "heron",
                           Z.ZOConfig(mu=MU, n_pairs=1),
                           P.FedConfig(n_clients=N, h=h), OPT.zo_sgd(LR),
                           sopt, uplink=uplink, client_lr=LR)
    rb_t = {k: torch.as_tensor(v) for k, v in rb.items()}
    return rnd(state, rb_t, np.asarray(KEY))


def _assert_tree_close(ours, ref, **tol):
    ref_leaves = jax.tree.leaves(ref)
    # jax.tree.map sorted the dict keys; walk ours in the same order
    ours_sorted = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), ours))
    assert len(ours_sorted) == len(ref_leaves)
    for a, b in zip(ours_sorted, ref_leaves):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("probe", ["weights", "scores"])
def test_round_params_match_jax(params, h, probe):
    rb = _round_batch(h)
    ref, jm = _jax_round(params, rb, h, probe=probe)
    new, m = _port_round(params, rb, h, probe=probe)
    _assert_tree_close(new["client"], ref["client"], **PARAM_TOL)
    _assert_tree_close(new["server"], ref["server"], **PARAM_TOL)
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert m["uplink_bytes"] == float(jm["uplink_bytes"])
    assert m["uplink_bytes_dense"] == float(jm["uplink_bytes_dense"])
    moved = [not np.array_equal(a.numpy(), b) for a, b in zip(
        jax.tree.leaves(jax.tree.map(lambda t: t, new["client"])),
        jax.tree.leaves(params["client"]))]
    assert any(moved)


def test_lean_uplink_matches_dense_at_h1(params):
    rb = _round_batch(1)
    lean, ml = _port_round(params, rb, 1, uplink="seed_replay")
    dense, md = _port_round(params, rb, 1, uplink="dense")
    for a, b in zip(tree_leaves(lean["client"]), tree_leaves(dense["client"])):
        torch.testing.assert_close(a, b, **PARAM_TOL)
    for a, b in zip(tree_leaves(lean["server"]), tree_leaves(dense["server"])):
        assert torch.equal(a, b)
    assert ml["uplink_bytes"] < md["uplink_bytes"] == ml["uplink_bytes_dense"]


@pytest.mark.parametrize("mask", [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("pred", [None, "attn_kv"])
def test_seed_replay_aggregate_matches_jax(params, mask, pred):
    tp = from_jax(params, device="cpu")["client"]
    rng = np.random.default_rng(5)
    coeffs = rng.standard_normal((3, 2, 2)).astype(np.float32)
    seeds = O.fold_seed(77, np.arange(3))
    tpred = O.attn_kv_seed_pred if pred else None
    jpred = JO.attn_kv_seed_pred if pred else None
    got = AG.seed_replay_aggregate_kernel(
        tp, seeds, torch.as_tensor(coeffs), 0.05, torch.tensor(mask),
        seed_pred=tpred)
    ref = JAG.seed_replay_aggregate_kernel(
        params["client"], jnp.asarray(seeds), jnp.asarray(coeffs), 0.05,
        jnp.asarray(mask), seed_pred=jpred)
    _assert_tree_close(got, jax.tree.map(np.asarray, ref), **PARAM_TOL)
    # a masked-out client's coefficients never reach the update
    poisoned = coeffs.copy()
    poisoned[[i for i, m in enumerate(mask) if m == 0.0]] = 1e6
    again = AG.seed_replay_aggregate_kernel(
        tp, seeds, torch.as_tensor(poisoned), 0.05, torch.tensor(mask),
        seed_pred=tpred)
    for a, b in zip(tree_leaves(again), tree_leaves(got)):
        assert torch.equal(a, b)


def test_replay_directions_bit_equal_and_coeffs_agree(params):
    """The (client, step, pair) seeds of a round give the JAX directions
    bit for bit; the port's coefficient agrees with the JAX one to a few
    f32 ulps of the loss over mu (ROADMAP "Faults")."""
    client_seeds = O.fold_seed(int(JZ.seed_from_key(KEY)), np.arange(N))
    np.testing.assert_array_equal(client_seeds, np.asarray(JO.fold_seed(
        JZ.seed_from_key(KEY), jnp.arange(N))))
    cp = params["client"]
    tcp = from_jax(cp, device="cpu")
    rb = _round_batch(1)
    jcfg = dataclasses.replace(jax_gpt2_tiny(), forward_impl="kernel")
    japi = JP.lm_api(jcfg, RULES)
    api = P.lm_api(dataclasses.replace(gpt2_tiny(), forward_impl="kernel"))
    for mu in (1e-3, 1e-2):
        zo, jzo = Z.ZOConfig(mu=mu), JZ.ZOConfig(mu=mu)
        seed = O.fold_seed(client_seeds[0], 0)
        bj = {k: v[0, 0] for k, v in rb.items()}
        bt = {k: torch.as_tensor(v) for k, v in bj.items()}
        gj, ij = jax.jit(lambda p, s: JZ.zo_gradient_kernel(
            lambda q, sd, m: japi.client_dual_loss(q, bj, sd, m), p, s,
            jzo))(cp, jnp.int32(seed))
        g, info = Z.zo_gradient_kernel(
            lambda q, sd, m: api.client_dual_loss(q, bt, sd, m), tcp, seed,
            zo)
        ulp = float(np.spacing(np.float32(info["loss"])))
        np.testing.assert_allclose(info["coeffs"].numpy(),
                                   np.asarray(ij["coeffs"]), rtol=0,
                                   atol=8 * ulp / mu)
        # directions: replay with the JAX coefficient reproduces JAX's g
        gr = Z.replay_gradient_kernel(
            tcp, seed, torch.as_tensor(np.array(ij["coeffs"])))
        _assert_tree_close(gr, jax.tree.map(np.asarray, gj), rtol=1e-6,
                           atol=1e-7)
    seeds = O.leaf_seed_tree(tcp, O.fold_seed(seed, 0))
    u = O.kernel_direction_tree(tcp, seeds)
    ju = JO.kernel_direction_tree(cp, JO.leaf_seed_tree(
        cp, jnp.int32(O.fold_seed(seed, 0))))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), u)),
                    jax.tree.leaves(ju)):
        np.testing.assert_array_equal(a, np.asarray(b))
