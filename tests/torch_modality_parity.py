"""Shared helpers of the modality archs' parity tests (``tests/test_torch_
vlm.py``, ``tests/test_torch_enc_dec.py``, ``tests/test_torch_enc_dec_
serve.py``, ``tests/test_torch_mrope.py``): qwen2-vl-2b's vision-stub and
seamless-m4t-medium's audio-stub batches from a numpy seed, M-RoPE grid
ids, and one HERON round of each package.  Not a test module."""
import dataclasses

import jax
import numpy as np

import torch_round_parity as RP
from repro.configs import registry as JREG
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.configs import registry as REG
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.optim import optimizers as OPT

VLM, ENC_DEC = "qwen2-vl-2b", "seamless-m4t-medium"
# tests/test_torch_dense_configs.py's forward tolerance and kernel-round
# rates (the server's AdamW eps 1e-6: a rounding-noise gradient entry
# moves a param by O(lr) at eps 1e-8)
TOL = dict(rtol=1e-5, atol=1e-5)
MU, LR, SERVER_LR, EPS, N = 1e-2, 1e-3, 1e-4, 1e-6, 2
KEY = jax.random.PRNGKey(9)
B, S = 2, 16


def setup(name):
    """``(jax smoke config, port smoke config, numpy params)``."""
    jcfg = JREG.get_config(name, smoke=True)
    p = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, REG.get_config(name, smoke=True), jax.tree.map(np.asarray,
                                                                  p)


def grid_ids(b, s, width=4):
    """(3, b, s) int32 M-RoPE ids of one image of ``s`` patches in rows of
    ``width``: t = 0, h = i // width, w = i % width, so the three
    sections rotate by different ids."""
    i = np.arange(s)
    return np.stack([np.zeros(s, int), i // width, i % width]).astype(
        np.int32)[:, None, :].repeat(b, axis=1)


def batch(cfg, lead=(), ids=True, seed=3, b=B, s=S):
    """A frontend stub's batch with leading axes ``lead`` (``(N, h)`` for
    a round): float (…, b, s, d_model) embeddings and (…, b, s) labels;
    qwen2-vl adds grid M-RoPE ids (…, 3, b, s) when ``ids``; seamless
    adds the decoder's tokens and the aux head's labels."""
    rng = np.random.default_rng(seed)
    lead = tuple(lead)
    out = {"inputs": rng.standard_normal(lead + (b, s, cfg.d_model)
                                         ).astype(np.float32),
           "labels": rng.integers(0, cfg.vocab, lead + (b, s))}
    if cfg.enc_dec:
        out["dec_tokens"] = rng.integers(0, cfg.vocab, lead + (b, s))
        out["aux_labels"] = rng.integers(0, cfg.vocab, lead + (b, s))
    elif ids:
        out["positions"] = np.broadcast_to(
            grid_ids(b, s), lead + (3, b, s)).copy()
    return out


def heron_rounds_match(name, stream, ids=True):
    """One HERON round (N=2, h=1, the lean uplink) of each package from
    the same params, batch and key: ``stream`` "kernel" is the fused dual
    probe's hash stream (JAX's Pallas kernels in interpret mode), and
    "threefry" the reference's default (gaussian directions).  States at
    ``PARAM_TOL``, metrics at its rtol."""
    jcfg, cfg, params = setup(name)
    jimpl, impl = (("kernel_interpret", "kernel") if stream == "kernel"
                   else ("xla", "xla"))
    japi = JP.lm_api(dataclasses.replace(jcfg, forward_impl=jimpl), RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl=impl))
    assert (api.client_dual_loss is None) == (stream == "threefry")
    rb = batch(cfg, (N, 1), ids=ids)
    kw = dict(uplink="seed_replay", client_lr=LR)
    scale = "sphere" if stream == "kernel" else "gaussian"
    ref, jm = RP.jax_round(japi, "heron", params, rb,
                           JP.FedConfig(n_clients=N, h=1), JOPT.zo_sgd(LR),
                           JOPT.adamw(SERVER_LR, eps=EPS), KEY,
                           JZ.ZOConfig(mu=MU, n_pairs=1, scale=scale), **kw)
    new, m = RP.port_round(api, "heron", params, rb,
                           P.FedConfig(n_clients=N, h=1), OPT.zo_sgd(LR),
                           OPT.adamw(SERVER_LR, eps=EPS), KEY,
                           Z.ZOConfig(mu=MU, n_pairs=1, scale=scale), **kw)
    RP.assert_state_close(new, ref, params)
    RP.assert_metrics_close(m, jm)
