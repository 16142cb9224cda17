"""Shared helpers of the round parity tests (``tests/test_torch_fo_*.py``,
``tests/test_torch_round_knobs.py``): one federated round of the JAX
package and of the port from the same params (through the bridge), the
same batches from a numpy seed and the same round key, and the
comparison of the resulting states and metrics.  Not a test module."""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.configs.recurrentgemma_9b import smoke_config as jax_rg_smoke
from repro.core import aggregate as JAG
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.distributed.sharding import AxisRules
from repro.models import cnn as JCNN
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.recurrentgemma_9b import smoke_config as rg_smoke
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.models import cnn as CNN
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs (import this fixture into a
    test module to use it): the threefry path is many small torch ops,
    and xdist runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# tests/test_torch_round.py's tolerance for the params after a round
PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
# the small CNN of benchmarks/run.py:_fed_accuracy
CNN_KW = dict(widths=(8, 16), blocks_per_stage=1, classes=4,
              client_blocks=1)


def lm_setup(jcfg=None, cfg=None):
    """``(jax_api, port_api, numpy params)`` of gpt2-tiny (or the given
    pair of configs)."""
    jcfg, cfg = jcfg or jax_gpt2_tiny(), cfg or gpt2_tiny()
    p = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return (JP.lm_api(jcfg, RULES), P.lm_api(cfg),
            jax.tree.map(np.asarray, p))


def cnn_setup():
    jcfg = JCNN.CNNConfig(**CNN_KW)
    p = JCNN.init_cnn(jax.random.PRNGKey(0), jcfg)
    return (JP.cnn_api(jcfg), P.cnn_api(CNN.CNNConfig(**CNN_KW)),
            jax.tree.map(np.asarray, p))


def rg_setup():
    return lm_setup(jax_rg_smoke(), rg_smoke())


def round_batch(kind, n, h, vocab=None, seed=3):
    """(N, h, ...) batches: 2 x 16 tokens (LM) or 4 images of 8x8x3."""
    rng = np.random.default_rng(seed)
    if kind == "cnn":
        return {"inputs": rng.standard_normal((n, h, 4, 8, 8, 3)
                                              ).astype(np.float32),
                "labels": rng.integers(0, CNN_KW["classes"], (n, h, 4))}
    toks = rng.integers(0, vocab, (n, h, 2, 17))
    return {"inputs": toks[..., :-1], "labels": toks[..., 1:]}


def jax_round(japi, method, params, rb, fed, copt, sopt, key, zo, **kw):
    state = {"client": params["client"], "server": params["server"],
             "opt_server": sopt.init(params["server"])}
    rnd = jax.jit(JP.make_fed_round(japi, method, zo, fed, copt, sopt,
                                    **kw))
    new, m = rnd(state, rb, key)
    return jax.tree.map(np.asarray, new), m


def port_round(api, method, params, rb, fed, copt, sopt, key, zo,
               mask=None, **kw):
    tp = from_jax(params, device="cpu")
    state = {"client": tp["client"], "server": tp["server"],
             "opt_server": sopt.init(tp["server"])}
    rnd = P.make_fed_round(api, method, zo, fed, copt, sopt, **kw)
    return rnd(state, {k: torch.as_tensor(v) for k, v in rb.items()},
               np.asarray(key),
               mask=None if mask is None else torch.tensor(mask))


def leaves(tree):
    """Leaves in JAX's order (sorted dict keys) as numpy arrays."""
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree))


def assert_state_close(new, ref, params, parts=("client", "server",
                                                "opt_server")):
    """Every leaf of each part at ``PARAM_TOL``, and the round moved the
    client."""
    for part in parts:
        got, want = leaves(new[part]), jax.tree.leaves(ref[part])
        assert len(got) == len(want), part
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert any(not np.array_equal(a, b) for a, b in zip(
        leaves(new["client"]), jax.tree.leaves(params["client"])))


def assert_metrics_close(m, jm):
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=PARAM_TOL["rtol"])
    for k in ("participants", "uplink_bytes", "uplink_bytes_dense"):
        assert float(m[k]) == float(jm[k]), k


# ---------------------------------------------------------------------------
# first-order rounds
# ---------------------------------------------------------------------------

# Exact first-order maths on both sides, so no 1/mu amplification; what
# remains is AdamW's first step, m/(sqrt(v)+eps) ~ g/|g|, which turns
# rounding in a near-zero gradient into an O(lr) change.  Small rates
# and eps=1e-6 on both sides (as the recurrentgemma round test) keep
# that under PARAM_TOL.
FO_LR, FO_SERVER_LR, FO_EPS, FO_MU, FO_N = 1e-4, 1e-4, 1e-6, 1e-2, 3
# PRNGKey(9) draws JAX's participation mask [1, 0, 1] at participation
# 2/3 (N=3); at participation 1 every key gives all ones
FO_KEY = jax.random.PRNGKey(9)
# (h, participation, the mask JAX draws): together the two cases cover
# h in {1, 2} and both masks for every method and model
FO_CASES = [(1, 1.0, [1.0, 1.0, 1.0]), (2, 2 / 3, [1.0, 0.0, 1.0])]
FO_CASE_IDS = ["h1-ones", "h2-mask101"]


def fo_round_pair(setup, method, rb, fed_kw, params=None, mask=None):
    """The first-order round of each package (AdamW client and server at
    the rates above) on ``rb``; the port gets ``mask``.  Checks the
    states and the metrics."""
    japi, api, p0 = setup
    params = p0 if params is None else params
    ref, jm = jax_round(japi, method, params, rb, JP.FedConfig(**fed_kw),
                        JOPT.adamw(FO_LR, eps=FO_EPS),
                        JOPT.adamw(FO_SERVER_LR, eps=FO_EPS), FO_KEY,
                        JZ.ZOConfig(mu=FO_MU))
    new, m = port_round(api, method, params, rb, P.FedConfig(**fed_kw),
                        OPT.adamw(FO_LR, eps=FO_EPS),
                        OPT.adamw(FO_SERVER_LR, eps=FO_EPS), FO_KEY,
                        Z.ZOConfig(mu=FO_MU), mask=mask)
    assert_state_close(new, ref, params)
    assert_metrics_close(m, jm)


def fo_round_case(kind, setup, method, case, params=None):
    """:func:`fo_round_pair` on one of ``FO_CASES``, JAX's mask checked
    and passed to the port."""
    h, part, want_mask = case
    jmask = np.asarray(JAG.straggler_mask(jax.random.fold_in(FO_KEY, 777),
                                          FO_N, part, 0.0))
    np.testing.assert_array_equal(jmask, want_mask)
    rb = round_batch(kind, FO_N, h, vocab=jax_gpt2_tiny().vocab)
    fo_round_pair(setup, method, rb,
                  dict(n_clients=FO_N, h=h, participation=part),
                  params=params, mask=jmask)


# ---------------------------------------------------------------------------
# HERON rounds on the threefry stream
# ---------------------------------------------------------------------------

# A coefficient is ``dim_factor (l_pert - l_clean) / mu``, and the two
# packages' losses differ by a few f32 ulps (other summation orders), so
# each client entry moves by about ``lr dim_factor |u| ulps / mu``:
# ``lr ulps / mu`` for gaussian directions (|u| ~ 1), and ``lr sqrt(d)
# ulps / mu`` on the sphere (|u| ~ 1 / sqrt(d); d ~ 1e5 on gpt2-tiny's
# client).  Gaussian rounds run mu 1e-2 and client lr 1e-3, as the kernel
# round's test; the sphere's sqrt(d) ~ 340 needs mu 1e-1 and client lr
# 1e-4 to stay under PARAM_TOL (the conditioning argument of
# tests/test_distributed.py's mu 1e-2).  scale -> (mu, client lr).
THREEFRY_RATES = {"gaussian": (1e-2, 1e-3), "sphere": (1e-1, 1e-4)}
THREEFRY_N, THREEFRY_SERVER_LR = 3, 1e-4


def threefry_case_ids(cases):
    return [f"h{h}-{scale}-{up}-p{part:.2f}-s{strag}"
            for h, scale, up, part, strag in cases]


def threefry_round_case(kind, case, key):
    """One HERON round of each package on the threefry stream (the
    configs' default ``forward_impl="xla"``), ``case = (h, scale,
    uplink, participation, straggler_prob)``: the port draws its own
    mask from ``key``.  Checks the states and the metrics."""
    h, scale, uplink, part, strag = case
    japi, api, params = lm_setup() if kind == "lm" else cnn_setup()
    assert api.client_dual_loss is None and japi.client_dual_loss is None
    mu, lr = THREEFRY_RATES[scale]
    fed = dict(n_clients=THREEFRY_N, h=h, participation=part,
               straggler_prob=strag)
    rb = round_batch(kind, THREEFRY_N, h, vocab=jax_gpt2_tiny().vocab)
    kw = dict(uplink=uplink,
              client_lr=lr if uplink == "seed_replay" else None)
    ref, jm = jax_round(japi, "heron", params, rb, JP.FedConfig(**fed),
                        JOPT.zo_sgd(lr), JOPT.adamw(THREEFRY_SERVER_LR), key,
                        JZ.ZOConfig(mu=mu, scale=scale), **kw)
    new, m = port_round(api, "heron", params, rb, P.FedConfig(**fed),
                        OPT.zo_sgd(lr), OPT.adamw(THREEFRY_SERVER_LR), key,
                        Z.ZOConfig(mu=mu, scale=scale), **kw)
    assert_state_close(new, ref, params)
    assert_metrics_close(m, jm)
    if part < 1:
        assert float(m["participants"]) < THREEFRY_N


# ---------------------------------------------------------------------------
# bf16 copies of gpt2-tiny (tests/test_torch_threefry_bf16*.py)
# ---------------------------------------------------------------------------

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# The two packages' bf16 forwards of gpt2-tiny round their activations
# in other places (and XLA fuses some roundings away); their losses stay
# within 1/20 of one bf16 step (2^-8) of each other.
BF16_LOSS_RTOL = 2e-4


def bf16_lm_setup():
    """:func:`lm_setup` of gpt2-tiny with bf16 params and compute."""
    return lm_setup(dataclasses.replace(jax_gpt2_tiny(), **BF16),
                    dataclasses.replace(gpt2_tiny(), **BF16))


def f32_leaves(tree):
    """Leaves of a port or a JAX tree in JAX's order (sorted dict keys)
    as f32 numpy (bf16 leaves widened exactly)."""
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.float().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t).astype(np.float32), tree))


def bf16_step(a, b):
    """One bf16 step at max(|a|, |b|), entrywise (f32 arrays)."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(ml_dtypes.bfloat16)
    up = np.nextafter(m, np.array(np.inf, ml_dtypes.bfloat16))
    return up.astype(np.float32) - m.astype(np.float32)


# ---------------------------------------------------------------------------
# the datacenter step (tests/test_torch_train_step*.py)
# ---------------------------------------------------------------------------

TRAIN_KEY = 1            # init_train_state's PRNGKey, as the launch driver
TRAIN_STEPS = 2


def step_batches(kind, vocab=None, n=TRAIN_STEPS, seed=4):
    """``n`` single-client batches: 2 x 16 tokens (LM) or 4 images of
    8x8x3, from a numpy seed."""
    rb = round_batch(kind, 1, n, vocab=vocab, seed=seed)
    return [{k: v[0, m] for k, v in rb.items()} for m in range(n)]


def train_steps_pair(setup, method, zo_pair, copt_pair, sopt_pair,
                     batches, params=None, tc_pred=None, ts_pred=None):
    """``len(batches)`` datacenter steps of each package from the same
    params and ``PRNGKey(TRAIN_KEY)``: ``((jax state, jax metrics),
    (port state, port metrics))``, the JAX side jitted as the reference's
    driver runs it.  Each ``*_pair`` is (JAX's, the port's)."""
    japi, api, p0 = setup
    params = p0 if params is None else params
    jstate = JP.init_train_state(jax.random.PRNGKey(TRAIN_KEY), params,
                                 copt_pair[0], sopt_pair[0], tc_pred,
                                 ts_pred)
    jstep = jax.jit(JP.make_train_step(japi, method, zo_pair[0],
                                       copt_pair[0], sopt_pair[0], tc_pred,
                                       ts_pred))
    state = P.init_train_state(R.PRNGKey(TRAIN_KEY),
                               from_jax(params, device="cpu"), copt_pair[1],
                               sopt_pair[1], tc_pred, ts_pred)
    step = P.make_train_step(api, method, zo_pair[1], copt_pair[1],
                             sopt_pair[1], tc_pred, ts_pred)
    for b in batches:
        jstate, jm = jstep(jstate, b)
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
    return (jax.tree.map(np.asarray, jstate), jm), (state, m)


def assert_train_state_close(state, jstate, params):
    """Params and both optimizer states at ``PARAM_TOL``, the step count
    and key equal, and the client moved."""
    for part in ("params", "opt_client", "opt_server"):
        got, want = leaves(state[part]), jax.tree.leaves(jstate[part])
        assert len(got) == len(want), part
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       **PARAM_TOL)
    assert state["step"] == int(jstate["step"])
    np.testing.assert_array_equal(state["rng"].numpy(), jstate["rng"])
    assert any(not np.array_equal(a, b) for a, b in zip(
        leaves(state["params"]["client"]),
        jax.tree.leaves(params["client"])))


# the mesh step tests' (tests/test_torch_train_mesh.py, test_torch_mesh_
# axes.py) rates: the kernel stream's and the gaussian threefry's (mu,
# client lr), the first-order (client lr, server lr, AdamW eps)
MESH_KERNEL_RATES = (1e-2, 1e-3)


def jax_heron_step(stream, arch="gpt2-tiny", eps=FO_EPS):
    """The reference's jitted single-device HERON step on gpt2-tiny (or
    the smoke config of the registry's ``arch``) from
    ``init_lm(PRNGKey(0))`` on :func:`mesh_step_inputs`' batch and rates
    (``stream`` "kernel" or "threefry", gaussian; the server's AdamW at
    ``eps``): ``(params after, params before)`` as ``{path: array}``."""
    from repro_torch.tree import tree_leaves_with_path
    inp = mesh_step_inputs()
    mu, lr = (float(x) for x in inp[f"{stream}_rates"])
    jcfg = (jax_gpt2_tiny() if arch == "gpt2-tiny"
            else JREG.get_config(arch, smoke=True))
    if stream == "kernel":
        jcfg = dataclasses.replace(jcfg, forward_impl="kernel")
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    copt = JOPT.zo_sgd(lr)
    sopt = JOPT.adamw(FO_SERVER_LR, eps=eps)
    state = JP.init_train_state(jax.random.PRNGKey(TRAIN_KEY), params,
                                copt, sopt)
    step = jax.jit(JP.make_train_step(
        JP.lm_api(jcfg, RULES), "heron", JZ.ZOConfig(mu=mu,
                                                    scale="gaussian"),
        copt, sopt))
    if arch in MESH_STUB_ARCHS:
        p = jcfg.family + "_"
        batch = {k[len(p):]: v for k, v in inp.items() if k.startswith(p)}
    else:
        batch = {"inputs": inp["batch_inputs"] % jcfg.vocab,
                 "labels": inp["batch_labels"] % jcfg.vocab}
    new, _ = step(state, batch)
    return tuple(dict(tree_leaves_with_path(jax.tree.map(np.asarray, t)))
                 for t in (new["params"], params))


def assert_mesh_heron_matches_jax(out, case, stream="kernel", jax_step=None):
    """The params a rank gathered from a mesh HERON step (``<case>|full|``
    keys of its results) against :func:`jax_heron_step` (on gpt2-tiny and
    ``stream``, or its result ``jax_step``) at ``PARAM_TOL``; the client
    moved."""
    want, start = jax_step or jax_heron_step(stream)
    prefix = f"{case}|full|"
    got = {k[len(prefix):]: v for k, v in out.items()
           if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, err_msg=path, **PARAM_TOL)
    assert any(not np.array_equal(v, start[p]) for p, v in want.items()
               if p.startswith("client/"))


# the archs whose frontend-stub batches mesh_step_inputs holds, under
# "<family>_<key>" (torch_train_mesh_ranks.STUB_FAMILIES)
MESH_STUB_ARCHS = ("qwen2-vl-2b", "seamless-m4t-medium")


def mesh_step_inputs():
    """The inputs of the mesh step's ranks (``torch_train_mesh_ranks``):
    the rates, one 2 x 16 text batch from a numpy seed (``batch_*``) and
    the modality archs' 2 x 16 frontend-stub batches of
    ``torch_modality_parity.batch``, keyed by family (``vlm_*``: patch
    embeddings and grid M-RoPE ids with distinct t / h / w; ``audio_*``:
    frame embeddings, the decoder's tokens and both heads' labels)."""
    import torch_modality_parity as MP
    from repro_torch.configs.registry import get_config
    b = step_batches("lm", vocab=jax_gpt2_tiny().vocab, n=1)[0]
    out = dict(kernel_rates=np.array(MESH_KERNEL_RATES),
               threefry_rates=np.array(THREEFRY_RATES["gaussian"]),
               fo_rates=np.array([FO_LR, FO_SERVER_LR, FO_EPS]),
               batch_inputs=b["inputs"], batch_labels=b["labels"])
    for arch in MESH_STUB_ARCHS:
        cfg = get_config(arch, smoke=True)
        out.update({f"{cfg.family}_{k}": v
                    for k, v in MP.batch(cfg).items()})
    return out
