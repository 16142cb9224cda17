"""The port's continuous-batching ``DecodeEngine`` against the JAX
package's on the CPU, for every decoder-only arch in the port's registry
(``torch_serve_parity.DECODER_ONLY``: the enc-dec keeps its token loop,
``tests/test_torch_enc_dec_serve.py``; smoke configs, f32): mixed-length
prompts (5 and 9 tokens) through 2 slots of
capacity 24 in segments of 4, as ``tests/test_serve.py`` drives the JAX
engine.  Greedy token streams must be JAX's exactly, and the port's
eager per-token ``make_serve_step`` loop's; one sampled configuration
must give JAX's sampled streams."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from torch_serve_parity import (DECODER_ONLY, RULES, TOL, assert_trees_close,
                                jax_config)
from repro.core import decode as JD
from repro.core import protocols as JP
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.core import decode as D
from repro_torch.core import protocols as P

jax.config.update("jax_platform_name", "cpu")

SAMPLED = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.95)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_engines():
    """The JAX engines jit a segment and an admission per arch: drop them
    once the module is done."""
    yield
    JD._FN_CACHE.clear()
    jax.clear_caches()


def _setup(arch):
    jcfg, cfg = jax_config(arch), REG.get_config(arch, smoke=True)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _prompts(vocab, lengths=(5, 9), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lengths]


def _run_jax(jcfg, jp, prompts, max_new, sampler=None, **kw):
    eng = JD.DecodeEngine(jp, jcfg, RULES, slots=2, capacity=24,
                          segment_len=4,
                          sampler=JD.SamplerConfig(**(sampler or {})), **kw)
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _run_port(cfg, tp, prompts, max_new, sampler=None, segment_len=4,
              keys=None, **kw):
    eng = D.DecodeEngine(tp, cfg, slots=2, capacity=24,
                         segment_len=segment_len,
                         sampler=D.SamplerConfig(**(sampler or {})),
                         device="cpu", **kw)
    keys = keys or [None] * len(prompts)
    rids = [eng.submit(p, max_new, key=k) for p, k in zip(prompts, keys)]
    out = eng.run()
    return [out[r] for r in rids], eng


def eager_greedy(tp, cfg, prompt, max_new, capacity=24):
    """The port's eager path: scalar-pos caches, one serve step per token
    (the prompt consumed token by token), argmax on the host."""
    serve = P.make_serve_step(cfg)
    caches = P.init_serve_caches(cfg, 1, capacity, device="cpu")
    prompt = torch.as_tensor(prompt, dtype=torch.int32)[None, :]
    with torch.inference_mode():
        for t in range(prompt.shape[1]):
            logits, caches = serve(tp, caches, prompt[:, t:t + 1])
        toks = []
        for _ in range(max_new):
            tok = int(torch.argmax(logits[0, -1, :cfg.vocab]))
            toks.append(tok)
            logits, caches = serve(tp, caches, torch.tensor([[tok]]))
    return toks


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_engine_greedy_streams_equal_jax_and_eager(arch):
    """Every port arch: the port engine's greedy streams == the JAX
    engine's == the port's eager per-token loop."""
    jcfg, cfg, jp, tp = _setup(arch)
    prompts = _prompts(cfg.vocab)
    ref = _run_jax(jcfg, jp, prompts, 6)
    got, eng = _run_port(cfg, tp, prompts, 6)
    assert got == ref, arch
    assert eng.segments == 2 and eng.prefill_tokens == 14
    assert eng.decoded_tokens == 12
    assert got == [eager_greedy(tp, cfg, p, 6) for p in prompts], arch


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_engine_sampled_streams_equal_jax(arch):
    """Temperature 0.8, top-k 40, top-p 0.95, the default request keys
    ``fold_in(PRNGKey(seed), rid)``: JAX's sampled streams."""
    jcfg, cfg, jp, tp = _setup(arch)
    prompts = _prompts(cfg.vocab, (5, 9, 7), seed=1)
    ref = _run_jax(jcfg, jp, prompts, 7, SAMPLED, seed=3)
    got, _ = _run_port(cfg, tp, prompts, 7, SAMPLED, seed=3)
    assert got == ref


def _eos_case():
    jcfg, cfg, jp, tp = _setup("qwen2-1.5b")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=7)
    return cfg, tp, prompt, eager_greedy(tp, cfg, prompt, 10)


def test_eos_early_exit_truncates_stream():
    """With ``eos_id`` a token the greedy stream emits mid-flight, the
    engine returns the prefix up to and including it."""
    cfg, tp, prompt, ref = _eos_case()
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    got, _ = _run_port(cfg, tp, [prompt], 10, eos_id=ref[k])
    assert got == [ref[:k + 1]]


def test_eos_on_prefill_token_finishes_without_slot():
    """A request whose first token is EOS finishes at admission and never
    runs a segment."""
    cfg, tp, prompt, ref = _eos_case()
    got, eng = _run_port(cfg, tp, [prompt], 10, eos_id=ref[0])
    assert got == [[ref[0]]]
    assert eng.segments == 0


def test_slot_recycling_invariance():
    """The same (prompt, key) samples the same tokens alone in a fresh
    engine and in a recycled slot behind other traffic."""
    _, cfg, _, tp = _setup("qwen2-1.5b")
    sampler = dict(greedy=False, temperature=0.9, top_k=20)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=8)
    key = jax.random.PRNGKey(42)
    (ref,), _ = _run_port(cfg, tp, [prompt], 8, sampler, keys=[key])
    rng = np.random.default_rng(6)
    crowded = D.DecodeEngine(tp, cfg, slots=2, capacity=24, segment_len=4,
                             sampler=D.SamplerConfig(**sampler),
                             device="cpu")
    for i in range(4):                       # force at least one recycle
        crowded.submit(rng.integers(0, cfg.vocab, size=5 + i), 6)
    rid = crowded.submit(prompt, 8, key=key)
    out = crowded.run()
    assert out[rid] == ref
    assert len(out) == 5


def test_segment_length_invariance():
    """Token streams do not depend on the segment length (the keys fold in
    the generated count, not the segment schedule)."""
    _, cfg, _, tp = _setup("qwen2-1.5b")
    sampler = dict(greedy=False, temperature=0.8, top_k=16)
    prompts = _prompts(cfg.vocab, (4, 6, 9), seed=7)
    assert (_run_port(cfg, tp, prompts, 7, sampler, segment_len=3)[0]
            == _run_port(cfg, tp, prompts, 7, sampler, segment_len=16)[0])


def test_prompt_consume_matches_jax():
    """The prompt fed token by token through the serve step: the last
    logits and the caches equal JAX's ``make_prompt_consume``."""
    jcfg, cfg, jp, tp = _setup("gemma2-27b")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, (2, 11)).astype(
        np.int32)
    jl, jc = jax.jit(JD.make_prompt_consume(jcfg, RULES))(
        jp, JP.init_serve_caches(jcfg, 2, 16), jnp.asarray(prompt))
    tl, tc = D.make_prompt_consume(cfg)(
        tp, P.init_serve_caches(cfg, 2, 16, device="cpu"),
        torch.as_tensor(prompt))
    assert tuple(tl.shape) == (2, 1, cfg.vocab_padded)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc))


def test_engine_and_launch_default_to_the_card():
    """Without ``device`` the engine, the serving caches and the driver
    ask for CUDA: without a card they raise rather than run on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, cfg, _, tp = _setup("gpt2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.DecodeEngine(tp, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.init_serve_caches(cfg, 1, 8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gpt2", "--smoke"])


def test_launch_serve_main_runs(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                       "--requests", "3", "--segment", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "prefill 18 tok" in out
    assert serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                       "cpu", "--prompt-len", "8", "--max-new", "3",
                       "--sample", "--temperature", "0.8", "--top-k",
                       "40"]) == 0
