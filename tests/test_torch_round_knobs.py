"""The round's knobs in the port against :mod:`repro.core.protocols` and
:mod:`repro.core.split` / :mod:`repro.core.aggregate`: the HERON round
with a smashed-data upload every second local step and with the int8
smashed uplink against JAX (gpt2-tiny and the small CNN, the lean uplink,
``PARAM_TOL``); the int8 quantizer's round trip bit for bit against
JAX's in f32 and bf16; ``client_costs`` for every method; and the
participation and straggler masks' semantics."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.core import split as JS
from repro.core import zo as JZ
from repro.models import cnn as JCNN
from repro.optim import optimizers as JOPT
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import split as S
from repro_torch.core import zo as Z
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

# tests/test_torch_round.py's rates for the HERON round (its comment
# gives the reasons)
MU, LR, SERVER_LR, N = 1e-2, 1e-3, 1e-4, 2
KEY = jax.random.PRNGKey(9)
# The int8 quantizer rounds: smashed data that differs by a few f32 ulps
# between the frameworks can land on the two sides of a rounding
# boundary, which moves that entry by a whole quantum (amax/127).  The
# quantized uploads are held where the clients' params are still the
# round's (step 0, uploaded at h=1 and at k=2); after ZO steps the
# smashed data differs by more (h=3 flipped one quantum of the server's
# input and moved a server param by 2.3x PARAM_TOL).
KNOBS = {"upload_every2": dict(h=2, upload_every=2),
         "quantize_uplink": dict(h=1, quantize_uplink=True),
         "both_h2": dict(h=2, upload_every=2, quantize_uplink=True)}


def _heron_setup(kind):
    if kind == "lm":
        jcfg = dataclasses.replace(jax_gpt2_tiny(), forward_impl="kernel")
        return RP.lm_setup(jcfg, dataclasses.replace(gpt2_tiny(),
                                                     forward_impl="kernel"))
    jcfg = JCNN.CNNConfig(**RP.CNN_KW, forward_impl="kernel")
    _, _, params = RP.cnn_setup()
    api = P.cnn_api(CNN.CNNConfig(**RP.CNN_KW, forward_impl="kernel"))
    return JP.cnn_api(jcfg), api, params


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("kind", ["lm", "cnn"])
def test_heron_round_knobs_match_jax(kind, knob):
    japi, api, params = _heron_setup(kind)
    fed_kw = dict(n_clients=N, **KNOBS[knob])
    rb = RP.round_batch(kind, N, fed_kw["h"], vocab=jax_gpt2_tiny().vocab)
    common = dict(uplink="seed_replay", client_lr=LR)
    ref, jm = RP.jax_round(japi, "heron", params, rb, JP.FedConfig(**fed_kw),
                           JOPT.zo_sgd(LR), JOPT.adamw(SERVER_LR), KEY,
                           JZ.ZOConfig(mu=MU, n_pairs=1), **common)
    new, m = RP.port_round(api, "heron", params, rb, P.FedConfig(**fed_kw),
                           OPT.zo_sgd(LR), OPT.adamw(SERVER_LR), KEY,
                           Z.ZOConfig(mu=MU, n_pairs=1), **common)
    RP.assert_state_close(new, ref, params)
    RP.assert_metrics_close(m, jm)


def test_upload_every_and_quantize_change_the_server_step():
    """The knobs reach the server: fewer server steps with k=2 (its AdamW
    step count), another server after the int8 uplink; the clients' ZO
    trajectory is the same."""
    cfg = dataclasses.replace(gpt2_tiny(), forward_impl="kernel")
    params = T.init_lm(cfg, seed=0, device="cpu")
    rb = {k: torch.as_tensor(v) for k, v in RP.round_batch(
        "lm", N, 2, vocab=cfg.vocab).items()}
    out = {}
    for name, kw in {"base": {}, "k2": dict(upload_every=2),
                     "q": dict(quantize_uplink=True)}.items():
        sopt = OPT.adamw(SERVER_LR)
        state = {"client": params["client"], "server": params["server"],
                 "opt_server": sopt.init(params["server"])}
        rnd = P.make_fed_round(P.lm_api(cfg), "heron", Z.ZOConfig(mu=MU),
                               P.FedConfig(n_clients=N, h=2, **kw),
                               OPT.zo_sgd(LR), sopt, uplink="seed_replay",
                               client_lr=LR)
        out[name] = rnd(state, rb, R.PRNGKey(11))
    assert out["base"][0]["opt_server"]["step"] == N * 2
    assert out["k2"][0]["opt_server"]["step"] == N * 1
    assert out["q"][0]["opt_server"]["step"] == N * 2
    for name in ("k2", "q"):
        assert float(out[name][1]["client_loss"]) == float(
            out["base"][1]["client_loss"])
        for a, b in zip(RP.leaves(out[name][0]["client"]),
                        RP.leaves(out["base"][0]["client"])):
            np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(
            RP.leaves(out[name][0]["server"]),
            RP.leaves(out["base"][0]["server"])))


def _smashed(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30.0, shape[:-1]
                                                  + (1,))).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0          # an all-zero row: amax 0
    x.reshape(-1, shape[-1])[1, :3] = [0.5, -0.5, 2.5]   # exact ties
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (2, 16, 64), (3, 8, 127)],
                         ids=["nhwc", "lm", "ragged"])
def test_quantize_roundtrip_bit_equal_to_jax(shape, dtype):
    jx, x = _smashed(shape, dtype, seed=sum(shape))
    jq, jscale = JS.quantize_smashed(jx)
    q, scale = S.quantize_smashed(x)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    jy = np.asarray(JS.dequantize_smashed(jq, jscale, dtype).astype(
        jnp.float32))
    y = S.dequantize_smashed(q, scale, x.dtype)
    assert y.dtype == x.dtype
    np.testing.assert_array_equal(y.to(torch.float32).numpy(), jy)


@pytest.mark.parametrize("method", JP.METHODS)
def test_client_costs_match_jax(method):
    for kw in (dict(p_batch_bytes=8 * 512 * 4,
                    q_smashed_bytes=8 * 512 * 1024 * 4, client_params=85e6,
                    aux_params=55e6, f_c=2 * 0.9e12, f_a=2 * 0.6e12),
               dict(p_batch_bytes=1000, q_smashed_bytes=5000,
                    client_params=123, aux_params=7, f_c=11.0, f_a=3.0,
                    n_pairs=3, bytes_per_param=2)):
        assert S.client_costs(method, **kw) == JS.client_costs(method, **kw)


def test_client_costs_rejects_unknown_method():
    with pytest.raises(ValueError):
        S.client_costs("fedsgd", p_batch_bytes=1, q_smashed_bytes=1,
                       client_params=1, aux_params=1, f_c=1.0, f_a=1.0)


def test_methods_match_jax():
    assert P.METHODS == JP.METHODS
    fields = {f.name for f in dataclasses.fields(P.FedConfig)}
    assert fields == {f.name for f in dataclasses.fields(JP.FedConfig)
                      } - {"sequential_server"}


@pytest.mark.parametrize("n,fraction", [(5, 1.0), (5, 0.5), (10, 0.35),
                                        (3, 2 / 3), (4, 0.01), (7, 0.1)])
def test_participation_mask_count(n, fraction):
    for seed in range(5):
        m = AG.participation_mask(R.PRNGKey(seed), n, fraction)
        assert m.shape == (n,) and m.dtype == torch.float32
        assert set(m.tolist()) <= {0.0, 1.0}
        assert int(m.sum()) == max(1, int(round(fraction * n)))


def test_straggler_mask_drops_and_falls_back():
    gen = R.PRNGKey
    # every participant drops: the participation mask itself
    for s in range(5):
        base = AG.participation_mask(gen(s), 6, 0.5)
        np.testing.assert_array_equal(
            AG.straggler_mask(gen(s), 6, 0.5, 1.0).numpy(), base.numpy())
    # no drop probability: the participation mask
    np.testing.assert_array_equal(AG.straggler_mask(gen(3), 6, 0.5).numpy(),
                                  AG.participation_mask(gen(3), 6,
                                                        0.5).numpy())
    # a survivor set inside the participants, and some drop across seeds
    dropped = 0
    for s in range(20):
        base = AG.participation_mask(gen(s), 8, 1.0)
        m = AG.straggler_mask(gen(s), 8, 1.0, 0.5)
        assert bool((m <= base).all()) and float(m.sum()) >= 1
        dropped += int(base.sum() - m.sum())
    assert dropped > 0


def test_fedavg_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": [rng.standard_normal((3, 2)).astype(np.float32)]}
    from repro.core import aggregate as JAG
    got = AG.fedavg(jax.tree.map(torch.as_tensor, tree))
    want = JAG.fedavg(tree)
    for a, b in zip(RP.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["heron", "cse_fsl", "sflv2"])
def test_round_mask_default_and_drawn(method):
    """All ones at participation 1 (every client); at participation < 1 or a
    straggler probability the round draws the mask from the round key:
    the right count, the same mask for the same seed, and only the
    participants' params reach the average."""
    cfg = CNN.CNNConfig(**RP.CNN_KW, forward_impl="kernel")
    params = CNN.init_cnn(cfg, seed=0, device="cpu")
    rb = {k: torch.as_tensor(v)
          for k, v in RP.round_batch("cnn", 4, 1).items()}

    def run(seed, **kw):
        copt = OPT.zo_sgd(LR) if method == "heron" else OPT.adamw(LR)
        sopt = OPT.adamw(SERVER_LR)
        state = {"client": params["client"], "server": params["server"],
                 "opt_server": sopt.init(params["server"])}
        rnd = P.make_fed_round(P.cnn_api(cfg), method, Z.ZOConfig(mu=MU),
                               P.FedConfig(n_clients=4, h=1, **kw), copt,
                               sopt)
        return rnd(state, rb, R.PRNGKey(seed))

    assert float(run(5)[1]["participants"]) == 4.0
    a, b = run(5, participation=0.5), run(5, participation=0.5)
    assert float(a[1]["participants"]) == 2.0
    for x, y in zip(RP.leaves(a[0]["client"]), RP.leaves(b[0]["client"])):
        np.testing.assert_array_equal(x, y)
    # the drawn mask, passed in, gives the same round
    mask = AG.straggler_mask(R.fold_in(R.PRNGKey(5), 777), 4, 0.5, 0.0)
    c = P.make_fed_round(
        P.cnn_api(cfg), method, Z.ZOConfig(mu=MU),
        P.FedConfig(n_clients=4, h=1),
        OPT.zo_sgd(LR) if method == "heron" else OPT.adamw(LR),
        OPT.adamw(SERVER_LR))(
            {"client": params["client"], "server": params["server"],
             "opt_server": OPT.adamw(SERVER_LR).init(params["server"])},
            rb, R.PRNGKey(5), mask=mask)
    for x, y in zip(RP.leaves(a[0]["client"]), RP.leaves(c[0]["client"])):
        np.testing.assert_array_equal(x, y)
    s = run(5, straggler_prob=0.9)
    assert 1.0 <= float(s[1]["participants"]) <= 4.0
