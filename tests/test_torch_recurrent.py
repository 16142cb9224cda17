"""The port's RG-LRU family (RecurrentGemma) against the JAX package on
recurrentgemma-9b's smoke config (f32): kernel K6's plain version against
the JAX sequential reference and the Pallas ``rg_lru_scan`` in interpret
mode, its gradient against ``jax.grad``, the causal conv and the RG-LRU
block, the embedding scale, the client forward and ZO losses through the
whole-block fallback (dual and single probe), and one HERON round with
the lean seed-replay uplink.  Inputs come from numpy seeds, params from
the JAX init through the bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_9b import smoke_config as jax_smoke_config
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.distributed.sharding import AxisRules
from repro.kernels import ops as JO
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.configs.recurrentgemma_9b import smoke_config
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.kernels import ref as R
from repro_torch.kernels import rg_lru as RG
from repro_torch.models import layers as L
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
# sequential (port) against associative (JAX) scan order: f32 ulps
TOL = dict(rtol=1e-5, atol=1e-6)
# whole forwards (the embedding scaled by 8, two blocks, residuals): the
# scan's few ulps of max |h| reach small entries as absolute error, so
# the absolute floor of tests/test_torch_model.py
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# the round's tolerances and rates, as tests/test_torch_round.py argues
MU, LR, SERVER_LR, N = 1e-2, 1e-3, 1e-4, 2
PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
# The server's first AdamW step is g/(|g| + eps).  On this config a few
# server gradient entries are rounding noise (~1e-9, against ~1e-3
# typical), and the port and JAX round them differently (the scan's
# two roundings against XLA's FMA): at eps=1e-8 that moved one wq entry
# by 0.2*lr.  eps=1e-6, the same on both sides, bounds the step's
# sensitivity to 1/eps, so a 1e-9 difference moves a param by < 1e-7.
SERVER_EPS = 1e-6
KEY = jax.random.PRNGKey(9)
SCAN_SHAPES = [(2, 64, 32, 16, 16), (1, 128, 64, 32, 64), (3, 32, 16, 8, 16)]


@pytest.fixture(scope="module")
def params():
    p = JT.init_lm(jax.random.PRNGKey(0), jax_smoke_config())
    return jax.tree.map(np.asarray, p)


def _scan_inputs(b, s, w, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    g = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, x, g


def _tokens(b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jax_smoke_config().vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _assert_within_ulps(ours, ref, n):
    """|ours - ref| <= n ulps of max |ref|, elementwise."""
    ref = np.asarray(ref)
    tol = n * np.spacing(np.float32(np.abs(ref).max()))
    assert float(np.abs(np.asarray(ours) - ref).max()) <= tol


@pytest.mark.parametrize("b,s,w,bt,bw", SCAN_SHAPES)
def test_rg_lru_scan_plain_matches_jax(b, s, w, bt, bw):
    """The port's plain scan (the CPU path of ``ops.rg_lru_scan``) rounds
    each step as a multiply, then an add: it equals a numpy loop of that
    form bit for bit.  XLA:CPU contracts ``a_t * h + b_t`` into one FMA in
    both the JAX sequential reference and the Pallas kernel in interpret
    mode, so they are not bit-equal to it; the contractive recurrence
    (|a| < 1) keeps the difference within 4 ulps of max |h| (2 measured at
    these shapes)."""
    a, x, _ = _scan_inputs(b, s, w)
    h = O.rg_lru_scan(torch.as_tensor(a), torch.as_tensor(x)).numpy()
    hn = np.zeros((b, w), np.float32)
    for t in range(s):
        hn = a[:, t] * hn + x[:, t]
        np.testing.assert_array_equal(h[:, t], hn)
    _assert_within_ulps(h, JREF.rg_lru_scan_ref(a, x), 4)
    _assert_within_ulps(h, JO.rg_lru_scan(
        jnp.asarray(a), jnp.asarray(x), bt=bt, bw=bw, interpret=True), 4)


@pytest.mark.parametrize("b,s,w,bt,bw", SCAN_SHAPES)
def test_rg_lru_scan_grad_matches_jax(b, s, w, bt, bw):
    """Autograd through the plain scan against ``jax.grad`` of the JAX
    reference, within 4 ulps of the gradient's max (the forward's FMA
    difference reaches da through h); and the plain reverse recurrence
    (the function of K6's reverse mode) equal to that autograd gradient
    bit for bit: both form the same two-term sums and products."""
    a, x, g = _scan_inputs(b, s, w, seed=6)
    jda, jdb = jax.grad(lambda p, q: jnp.sum(JREF.rg_lru_scan_ref(p, q) * g),
                        argnums=(0, 1))(a, x)
    ta = torch.as_tensor(a).requires_grad_(True)
    tx = torch.as_tensor(x).requires_grad_(True)
    h = O.rg_lru_scan(ta, tx)
    da, db = torch.autograd.grad(torch.sum(h * torch.as_tensor(g)), (ta, tx))
    _assert_within_ulps(da.numpy(), jda, 4)
    _assert_within_ulps(db.numpy(), jdb, 4)
    rda, rdb = RG.rg_lru_scan_reverse(ta.detach(), torch.as_tensor(g),
                                      h.detach())
    torch.testing.assert_close(rda, da, rtol=0, atol=0)
    torch.testing.assert_close(rdb, db, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape"])
def test_rg_lru_scan_refuses_what_k6_does_not_take(bad):
    a, x, _ = (torch.as_tensor(t) for t in _scan_inputs(1, 8, 4))
    if bad == "dtype":
        a = a.double()
    elif bad == "rank":
        a, x = a[0], x[0]
    else:
        x = x[:, :7]
    with pytest.raises(ValueError):
        O.rg_lru_scan(a, x)
    with pytest.raises(ValueError):
        RG.rg_lru_scan_reverse(a, x, x)


def test_conv1d_and_rg_lru_block_match_jax():
    jcfg, cfg = jax_smoke_config(), smoke_config()
    pb = JL.ParamBuilder(jax.random.PRNGKey(1), "init", jnp.float32)
    jp = JR.init_rg_lru(pb, "rec", jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    conv_ref = JL.causal_conv1d(jp["conv"], jnp.asarray(x))
    conv = L.causal_conv1d(tp["conv"], torch.as_tensor(x))
    np.testing.assert_allclose(conv.numpy(), np.asarray(conv_ref), **TOL)
    out_ref, _ = JR.rg_lru_block(jp, jnp.asarray(x), jcfg, RULES)
    out, _ = REC.rg_lru_block(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    # the lru_lambda init inverts softplus(lam) = -8 log(u), u uniform in
    # [0.9, 0.999], as the JAX init does (other draws, the same band)
    for lam in (L.init_param(torch.Generator().manual_seed(0), (4096,),
                             torch.float32, "lru_lambda"),
                torch.as_tensor(np.array(jp["lam"]))):
        u = torch.exp(-torch.nn.functional.softplus(lam) / 8.0)
        assert bool(((u >= 0.9 - 1e-5) & (u <= 0.999 + 1e-5)).all())


def test_init_lm_tree_paths_shapes_and_embed_scale(params):
    ours = T.init_lm(smoke_config(), seed=0, device="cpu")
    ref = sorted((p, a.shape) for p, a in tree_leaves_with_path(params))
    got = sorted((p, tuple(t.shape)) for p, t in tree_leaves_with_path(ours))
    assert got == ref
    assert ("client/layers/0/0/rec/lam", (2, 64)) in got
    inputs, _ = _tokens()
    jcfg, cfg = jax_smoke_config(), smoke_config()
    x_ref = JT.embed_inputs(params["client"], jcfg, inputs)
    x = T.embed_inputs(from_jax(params["client"], device="cpu"), cfg,
                       torch.as_tensor(inputs))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    table = params["client"]["embed"]["table"]
    np.testing.assert_array_equal(x.numpy(), table[inputs] * np.float32(8.0))


def test_forwards_and_loss_match_jax(params):
    inputs, labels = _tokens()
    jcfg, cfg = jax_smoke_config(), smoke_config()
    tp = from_jax(params, device="cpu")
    s_ref = jax.jit(lambda p, i: JT.client_forward(p, jcfg, RULES, i)[0])(
        params["client"], inputs)
    s = T.client_forward(tp["client"], cfg, torch.as_tensor(inputs))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **FWD_TOL)
    lg_ref = jax.jit(lambda p, x: JT.server_forward(p, jcfg, RULES, x)[0])(
        params, s_ref)
    lg = T.server_forward(tp, cfg, s)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(T.lm_loss(lg, torch.as_tensor(labels), cfg.vocab)),
        float(JT.lm_loss(lg_ref, labels, jcfg.vocab)), rtol=1e-6)


@pytest.mark.parametrize("mu", [0.0, 1e-2])
def test_client_dual_loss_matches_jax(params, mu):
    """l_clean, l_pert and the smashed data of one dual-probe pass: the
    two RG-LRU client blocks run the whole-block fallback (clean params
    on the first half, theta + mu*U on the second)."""
    jcfg = dataclasses.replace(jax_smoke_config(), forward_impl="kernel")
    japi = JP.lm_api(jcfg, RULES)
    api = P.lm_api(dataclasses.replace(smoke_config(), forward_impl="kernel"))
    inputs, labels = _tokens()
    cp = params["client"]
    l0r, lpr, sr = jax.jit(japi.client_dual_loss)(
        cp, {"inputs": inputs, "labels": labels},
        JO.leaf_seed_tree(cp, jnp.int32(-12345)), mu)
    l0, lp, s = api.client_dual_loss(
        from_jax(cp, device="cpu"),
        {"inputs": torch.as_tensor(inputs),
         "labels": torch.as_tensor(labels)},
        O.leaf_seed_tree(cp, -12345), mu)
    np.testing.assert_allclose(float(l0), float(l0r), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(lpr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **FWD_TOL)
    assert (float(l0) == float(lp)) == (mu == 0.0)


@pytest.mark.parametrize("mu", [0.0, 1e-2])
def test_single_probe_matches_jax_and_dual_l_pert(params, mu):
    """``Perturb(dual=False)``: the fallback runs the perturbed block
    alone; its loss is also the l_pert of the port's dual pass."""
    jcfg = dataclasses.replace(jax_smoke_config(),
                               forward_impl="kernel_interpret")
    cfg = dataclasses.replace(smoke_config(), forward_impl="kernel")
    cp = params["client"]
    inputs, labels = _tokens(seed=4)
    jpz = JO.Perturb(seeds=JO.leaf_seed_tree(cp, jnp.int32(77)), mu=mu,
                     dual=False, impl="interpret")

    def jloss(p):
        s, _ = JT.client_forward(p, jcfg, RULES, inputs, perturb=jpz)
        lg = JT.aux_forward(p, jcfg, RULES, s, perturb=jpz)
        return JT.lm_loss(lg, labels, jcfg.vocab), s

    lr, sr = jax.jit(jloss)(cp)
    tcp = from_jax(cp, device="cpu")
    ti, tl = torch.as_tensor(inputs), torch.as_tensor(labels)
    seeds = O.leaf_seed_tree(tcp, 77)
    pz = O.Perturb(seeds=seeds, mu=mu, dual=False)
    s = T.client_forward(tcp, cfg, ti, perturb=pz)
    loss = T.lm_loss(T.aux_forward(tcp, cfg, s, perturb=pz), tl, cfg.vocab)
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **FWD_TOL)
    _, lp, _ = P.lm_api(cfg).client_dual_loss(
        tcp, {"inputs": ti, "labels": tl}, seeds, mu)
    np.testing.assert_allclose(float(loss), float(lp), rtol=1e-5)


def _round_batch(h, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jax_smoke_config().vocab, (N, h, b, s + 1))
    return {"inputs": toks[..., :-1], "labels": toks[..., 1:]}


def _jax_round(params, rb, h):
    cfg = dataclasses.replace(jax_smoke_config(), forward_impl="kernel")
    sopt = JOPT.adamw(SERVER_LR, eps=SERVER_EPS)
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rnd = jax.jit(JP.make_fed_round(
        JP.lm_api(cfg, RULES), "heron", JZ.ZOConfig(mu=MU, n_pairs=1),
        JP.FedConfig(n_clients=N, h=h), JOPT.zo_sgd(LR), sopt,
        uplink="seed_replay", client_lr=LR))
    new, m = rnd(state, rb, KEY)
    return jax.tree.map(np.asarray, new), m


def _port_round(params, rb, h):
    sopt = OPT.adamw(SERVER_LR, eps=SERVER_EPS)
    tp = from_jax(params, device="cpu")
    state = {"client": tp["client"], "server": tp["server"],
             "opt_server": sopt.init(tp["server"])}
    kcfg = dataclasses.replace(smoke_config(), forward_impl="kernel")
    rnd = P.make_fed_round(P.lm_api(kcfg), "heron",
                           Z.ZOConfig(mu=MU, n_pairs=1),
                           P.FedConfig(n_clients=N, h=h), OPT.zo_sgd(LR),
                           sopt, uplink="seed_replay", client_lr=LR)
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
def test_round_params_match_jax(params, h):
    """One HERON round (N=2, seed-replay uplink): the server
    differentiates through the scan (autograd over the plain version on
    the CPU, K6's reverse mode on the card)."""
    rb = _round_batch(h)
    ref, jm = _jax_round(params, rb, h)
    new, m = _port_round(params, rb, h)
    _assert_tree_close(new["client"], ref["client"], **PARAM_TOL)
    _assert_tree_close(new["server"], ref["server"], **PARAM_TOL)
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert m["uplink_bytes"] == float(jm["uplink_bytes"])
    assert m["uplink_bytes_dense"] == float(jm["uplink_bytes_dense"])
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), new["client"])),
        jax.tree.leaves(params["client"]))]
    assert any(moved)


def test_replayed_rec_directions_bit_equal(params):
    """The replayed direction of every leaf of the RG-LRU client blocks
    (stacked (reps, ...) leaves, the 1-D ``lam`` as (reps, W)) equals the
    JAX one bit for bit, and each rep slice of it is the noise the
    fallback perturbs that rep with."""
    cp = params["client"]
    tcp = from_jax(cp, device="cpu")
    seed = O.fold_seed(O.fold_seed(int(JZ.seed_from_key(KEY)), 1), 0)
    seeds = O.leaf_seed_tree(tcp, seed)
    u = O.kernel_direction_tree(tcp, seeds)
    ju = jax.tree.map(np.asarray, JO.kernel_direction_tree(
        cp, JO.leaf_seed_tree(cp, jnp.int32(seed))))
    rec = [(p, t) for p, t in tree_leaves_with_path(u["layers"])
           if "/rec/" in p]
    assert len(rec) == 10
    for p, t in rec:
        node = ju["layers"]
        for k in p.split("/"):
            node = node[int(k)] if isinstance(node, (list, tuple)) else \
                node[k]
        np.testing.assert_array_equal(t.numpy(), node)
    lam, s_lam = tcp["layers"][0][0]["rec"]["lam"], \
        seeds["layers"][0][0]["rec"]["lam"]
    for r in range(lam.shape[0]):
        pr = O.perturb_tree(lam[r], s_lam, 1.0, r)
        torch.testing.assert_close(
            pr - lam[r], u["layers"][0][0]["rec"]["lam"][r], rtol=0,
            atol=1e-6)
