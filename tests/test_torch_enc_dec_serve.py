"""seamless-m4t-medium's serving in the port against the JAX package on
its smoke config (f32): the enc-dec serve caches' tree (the decoder
stack's KV caches and ``enc_out``); the decoder step and the token-by-
token prompt consume on a fixed encoder output, logits and caches at
``rtol=atol=1e-5``; the serving driver's greedy and sampled token loops
equal to the reference driver's (``repro.launch.serve._serve_enc_dec``)
token for token; and the decoder-only paths refusing the enc-dec as the
reference's do."""
import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_modality_parity as MP
from torch_round_parity import one_torch_thread  # noqa: F401
from torch_serve_parity import RULES, TOL, assert_trees_close
from repro.configs import registry as JREG
from repro.core import decode as JD
from repro.core import protocols as JP
from repro.launch import serve as JSERVE
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.core import decode as D
from repro_torch.core import protocols as P
from repro_torch.launch import serve as SERVE

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("smoke", [True, False])
def test_init_serve_caches_tree_matches_jax(smoke):
    jcfg = JREG.get_config(MP.ENC_DEC, smoke)
    cfg = REG.get_config(MP.ENC_DEC, smoke)
    ref = jax.tree.map(np.asarray, JP.init_serve_caches(jcfg, 2, 12))
    got = P.init_serve_caches(cfg, 2, 12, device="cpu")
    assert set(got) == {"dec", "enc_out"}
    assert_trees_close(got, ref, tol=dict(rtol=0, atol=0))


def test_serve_step_and_prompt_consume_match_jax():
    """A 5-token prompt consumed into caches of 9 over a seeded encoder
    output, then two decoder steps: logits and caches (the decoder's KV
    rows and positions, ``enc_out`` untouched) at 1e-5."""
    jcfg, cfg, params = MP.setup(MP.ENC_DEC)
    tp = from_jax(params, device="cpu")
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    jc = {**JP.init_serve_caches(jcfg, 2, 9), "enc_out": jnp.asarray(enc)}
    tc = P.init_serve_caches(cfg, 2, 9, device="cpu")
    tc["enc_out"].copy_(torch.as_tensor(enc))
    jl, jc = jax.jit(JD.make_prompt_consume(jcfg, RULES))(
        params, jc, jnp.asarray(prompt))
    tl, tc = D.make_prompt_consume(cfg)(tp, tc, torch.as_tensor(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc))
    jserve, serve = jax.jit(JP.make_serve_step(jcfg, RULES)), \
        P.make_serve_step(cfg)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jserve(params, jc, jnp.asarray(tok))
        tl, tc = serve(tp, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_trees_close(tc, jax.tree.map(np.asarray, jc))
    assert int(tc["dec"][0][0]["attn"]["pos"][0]) == 7


def _first_row(out):
    """The token row the driver prints last (the reference prints a
    numpy array, the port a list)."""
    last = out.strip().splitlines()[-1]
    return [int(t) for t in re.findall(r"-?\d+", last)]


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_token_loop_equals_reference_driver(sample, capsys):
    """Both drivers' enc-dec loop (batch 2, a 6-token prompt, 8 new
    tokens, seed 5; sampled at temperature 0.8, top-k 40, top-p 0.95):
    each package's params from ``init_lm(PRNGKey(0))``, encoder output
    ``normal(PRNGKey(3))``, prompt ``randint(PRNGKey(1))``.  The streams
    are equal token for token."""
    flags = ["--arch", MP.ENC_DEC, "--smoke", "--batch", "2",
             "--prompt-len", "6", "--max-new", "8", "--seed", "5"]
    if sample:
        flags += ["--sample", "--temperature", "0.8", "--top-k", "40",
                  "--top-p", "0.95"]
    assert SERVE.main(flags + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] modality archs: serving the text decoder only" in out
    assert "[serve] enc-dec generated (2, 8)" in out
    got = _first_row(out)
    args = argparse.Namespace(batch=2, prompt_len=6, max_new=8, seed=5)
    jcfg = JREG.get_config(MP.ENC_DEC, smoke=True)
    sampler = JD.SamplerConfig(greedy=not sample, temperature=0.8,
                               top_k=40 if sample else 0,
                               top_p=0.95 if sample else 1.0)
    assert JSERVE._serve_enc_dec(jcfg, args, sampler) == 0
    want = _first_row(capsys.readouterr().out)
    assert len(got) == 8 and got == want


def test_decoder_only_paths_refuse_enc_dec():
    _, cfg, params = MP.setup(MP.ENC_DEC)
    tp = from_jax(params, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        D.DecodeEngine(tp, cfg, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        P.make_cached_prefill_step(cfg)
