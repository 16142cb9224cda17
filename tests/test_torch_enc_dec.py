"""seamless-m4t-medium (the enc-dec with the audio frontend stub) in the
port against the JAX package on its smoke config (f32): ``init_lm(key=)``
draws the reference's tree, the decoder's ``dec_embed`` and
cross-attended ``decoder`` stack included; the whole model's forward on
float frame embeddings and decoder tokens; HERON rounds on both streams
(the kernel stream against the reference's Pallas kernels in interpret
mode); a CSE-FSL round (first-order clients on the aux head) and an SFLV2
round (the training lock, through the decoder's cross-attention); two
datacenter HERON steps; and the train state's checkpoint written by one
package and restored by the other bit for bit.

The client holds the encoder's first ``cut_layers`` blocks; the server
the rest of the encoder, ``dec_embed``, the decoder and the final norm
that ends both."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_modality_parity as MP
import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.checkpoint import checkpoint as JC
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.checkpoint import checkpoint as C
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

ULP = float(np.finfo(np.float32).eps)


def test_init_lm_with_key_equals_jax_init():
    jcfg, cfg, _ = MP.setup(MP.ENC_DEC)
    want = jax.tree.leaves_with_path(JT.init_lm(jax.random.PRNGKey(0), jcfg))
    got = tree_leaves_with_path(T.init_lm(cfg, device="cpu",
                                          key=R.PRNGKey(0)), sort_keys=True)
    paths = [p for p, _ in got]
    assert "server/dec_embed/table" in paths
    assert "server/decoder/0/0/cross/wq/w" in paths
    assert "server/decoder/0/0/cross_norm/scale" in paths
    assert paths == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=4 * ULP * max(np.abs(b).max(),
                                                      1e-30))
    # the decoder's stack: its layers, each with a cross sub-block
    dec = got[paths.index("server/decoder/0/0/cross/wq/w")][1]
    assert dec.shape[0] == cfg.n_layers - cfg.n_enc_layers


def test_full_forward_with_dec_tokens_matches_jax():
    jcfg, cfg, params = MP.setup(MP.ENC_DEC)
    b = MP.batch(cfg)
    ref = jax.jit(lambda p, x, d: JT.full_forward(p, jcfg, RP.RULES, x,
                                                  dec_tokens=d))(
        params, b["inputs"], b["dec_tokens"])
    tp = from_jax(params, device="cpu")
    got = T.full_forward(tp, cfg, torch.as_tensor(b["inputs"]),
                         dec_tokens=torch.as_tensor(b["dec_tokens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MP.TOL)
    # the losses of the API: aux head on aux_labels, server on labels
    japi, api = JP.lm_api(jcfg, RP.RULES), P.lm_api(cfg)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    (jl, js), (tl, ts) = japi.client_loss(params["client"], b), \
        api.client_loss(tp["client"], tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(
        float(api.joint_loss(tp["client"], tp["server"], tb)),
        float(japi.joint_loss(params["client"], params["server"], b)),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(api.server_loss(tp["server"], tp["client"], ts, tb)),
        float(japi.server_loss(params["server"], params["client"], js, b)),
        rtol=1e-6)


@pytest.mark.parametrize("stream", ["kernel", "threefry"])
def test_heron_round_matches_jax(stream):
    MP.heron_rounds_match(MP.ENC_DEC, stream)


@pytest.mark.parametrize("method", ["cse_fsl", "sflv2"])
def test_fo_round_matches_jax(method):
    """torch_round_parity's first-order rates, h=1, all clients."""
    jcfg, cfg, params = MP.setup(MP.ENC_DEC)
    rb = MP.batch(cfg, (RP.FO_N, 1))
    fed = dict(n_clients=RP.FO_N, h=1)
    ref, jm = RP.jax_round(
        JP.lm_api(jcfg, RP.RULES), method, params, rb, JP.FedConfig(**fed),
        JOPT.adamw(RP.FO_LR, eps=RP.FO_EPS),
        JOPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS), RP.FO_KEY,
        JZ.ZOConfig(mu=RP.FO_MU))
    new, m = RP.port_round(
        P.lm_api(cfg), method, params, rb, P.FedConfig(**fed),
        OPT.adamw(RP.FO_LR, eps=RP.FO_EPS),
        OPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS), RP.FO_KEY,
        Z.ZOConfig(mu=RP.FO_MU))
    RP.assert_state_close(new, ref, params)
    RP.assert_metrics_close(m, jm)


def test_heron_train_step_matches_jax():
    """Two datacenter HERON steps on the kernel stream (the reference's
    Pallas kernels in interpret mode), as the reference's driver builds
    enc-dec batches (frame embeddings, decoder tokens, aux labels)."""
    jcfg, cfg, params = MP.setup(MP.ENC_DEC)
    setup = (JP.lm_api(dataclasses.replace(jcfg,
                                           forward_impl="kernel_interpret"),
                       RP.RULES),
             P.lm_api(cfg.replace(forward_impl="kernel")), params)
    assert setup[1].client_dual_loss is not None
    batches = [MP.batch(cfg, seed=s) for s in (4, 5)]
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, "heron", (JZ.ZOConfig(mu=MP.MU), Z.ZOConfig(mu=MP.MU)),
        (JOPT.zo_sgd(MP.LR), OPT.zo_sgd(MP.LR)),
        (JOPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS),
         OPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS)), batches)
    RP.assert_train_state_close(st, jst, params)
    for k in ("loss", "client_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=RP.PARAM_TOL["rtol"])


@pytest.fixture(scope="module")
def train_states():
    """The seamless smoke train state in each package (AdamW on both
    sides), at step 3."""
    _, _, params = MP.setup(MP.ENC_DEC)
    jopt, opt = JOPT.adamw(1e-3), OPT.adamw(1e-3)
    jst = JP.init_train_state(jax.random.PRNGKey(1), params, jopt, jopt)
    jst = {**jst, "step": np.asarray(3, np.int32)}
    st = P.init_train_state(R.PRNGKey(1), from_jax(params, "cpu"), opt, opt)
    return jst, {**st, "step": 3}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_round_trip_across_packages(tmp_path, train_states,
                                               writer):
    jst, st = train_states
    if writer == "port":
        C.save(str(tmp_path), 3, st)
        got, step = JC.restore(str(tmp_path), jst)
        mine = [np.asarray(t) for t in jax.tree.leaves(got)]
    else:
        JC.save(str(tmp_path), 3, jst)
        got, step = C.restore(str(tmp_path), st)
        assert got["step"] == 3
        mine = [t.numpy() if torch.is_tensor(t) else np.asarray(t)
                for _, t in tree_leaves_with_path(got, sort_keys=True)]
    want = jax.tree.leaves(jst)
    assert step == 3 and len(mine) == len(want)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
