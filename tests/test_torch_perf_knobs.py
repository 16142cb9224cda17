"""The reference's two attention knobs in the port: ``causal_skip`` and
``attn_p_dtype`` (``ModelConfig`` fields, threaded into
``models.attention.blocked_attention`` as the reference does; the
cross-attention keeps ``causal_skip=False``).

* ``blocked_attention`` with each knob equals the reference's with the
  same knob (causal, local window, soft-cap; ragged tiles against the
  reference's padded ones) at ``REF_TOL``;
* ``causal_skip`` equals no-skip within ``SKIP_TOL``: the tiles it skips
  are fully masked, and their contribution is exactly zero (on the CPU
  the outputs are equal bit for bit);
* ``attn_p_dtype="bfloat16"`` stays within ``P_BF16_BAR`` of the f32 p:
  ``p`` and ``v`` rounded to bf16 move each output by at most 2^-9 of
  max|v| each, and a bf16 output's rounding one bf16 ulp more, so the
  bar is 2^-7 * max|v|;
* ``full_forward`` with the knobs equals the reference's on a tiny
  config from the same params;
* ``causal_skip`` cuts the counted FLOPs of a causal call to the visited
  tiles: at S 4096 in 1024-chunks, 10 of 16.
These bars are the ones ``chip_smoke.py`` phase 22 (b) holds the card to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import AxisRules
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from torch_round_parity import one_torch_thread  # noqa: F401
from repro_torch.bridge import from_jax
from repro_torch.launch import costs as C
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

REF_TOL = dict(rtol=1e-5, atol=1e-6)
SKIP_TOL = dict(rtol=0.0, atol=1e-6)
P_BF16_BAR = 2.0 ** -7          # x max|v|
FWD_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(S=40, B=2, H=4, Kv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (H, Kv, Kv))


def _port(q, k, v, **kw):
    return A.blocked_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                               **kw).numpy()


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("window,cap,S", [(0, None, 40), (12, None, 40),
                                          (10, None, 40), (0, 5.0, 36),
                                          (12, 5.0, 36)])
def test_blocked_attention_knobs_equal_reference(p_dtype, skip, window, cap,
                                                 S):
    q, k, v = _qkv(S)
    kw = dict(window=window, cap=cap, q_chunk=8, kv_chunk=8,
              causal_skip=skip)
    want = np.asarray(JA.blocked_attention(
        *(jnp.asarray(x) for x in (q, k, v)), p_dtype=jnp.dtype(p_dtype),
        **kw))
    got = _port(q, k, v, p_dtype=getattr(torch, p_dtype), **kw)
    np.testing.assert_allclose(got, want, **REF_TOL)


@pytest.mark.parametrize("chunks", [(8, 8), (8, 7), (5, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 8, 10, 12])
def test_causal_skip_equals_no_skip(dtype, window, chunks):
    """Windows 8 and 10 put a tile's edge on the window's first attended
    position (q0 - window + 1) for some q block, 12 inside a tile;
    unequal chunks put a kv tile's first position on a q block's last."""
    q, k, v = (torch.as_tensor(x).to(dtype) for x in _qkv())
    kw = dict(window=window, q_chunk=chunks[0], kv_chunk=chunks[1])
    a = A.blocked_attention(q, k, v, **kw)
    b = A.blocked_attention(q, k, v, causal_skip=True, **kw)
    torch.testing.assert_close(b.float(), a.float(), **SKIP_TOL)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_p_bf16_within_its_bar(dtype):
    q, k, v = (torch.as_tensor(x).to(dtype) for x in _qkv())
    kw = dict(q_chunk=8, kv_chunk=8)
    a = A.blocked_attention(q, k, v, **kw).float()
    b = A.blocked_attention(q, k, v, p_dtype=torch.bfloat16, **kw).float()
    err = float((a - b).abs().max())
    assert 0 < err <= P_BF16_BAR * float(v.float().abs().max())


def _tiny(cls, **kw):
    return cls(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
               d_ff=64, vocab=31, cut_layers=1, param_dtype="float32",
               compute_dtype="float32", q_chunk=8, kv_chunk=8, **kw)


@pytest.mark.parametrize("knobs", [
    dict(causal_skip=True), dict(attn_p_dtype="bfloat16"),
    dict(causal_skip=True, attn_p_dtype="bfloat16")],
    ids=["skip", "p_bf16", "both"])
def test_full_forward_knobs_equal_reference(knobs):
    jcfg, cfg = _tiny(JModelConfig, **knobs), _tiny(ModelConfig, **knobs)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                                       31))
    want = np.asarray(JT.full_forward(params, jcfg, AxisRules(mesh=None),
                                      jnp.asarray(toks)))
    got = T.full_forward(from_jax(jax.tree.map(np.asarray, params), "cpu"),
                         cfg, torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    plain = T.full_forward(from_jax(jax.tree.map(np.asarray, params),
                                    "cpu"), _tiny(ModelConfig),
                           torch.as_tensor(toks)).numpy()
    if "attn_p_dtype" in knobs:
        assert np.abs(got - plain).max() > 0
    else:
        np.testing.assert_array_equal(got, plain)


def test_causal_skip_counts_the_visited_tiles():
    """qwen2-1.5b's heads (12 q, 2 kv, D 128), B 1, S 4096 in 1024-chunks
    on meta: 10 of the 16 tiles are visited."""
    q = torch.empty((1, 4096, 12, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 4096, 2, 128), dtype=torch.bfloat16, device="meta")

    def flops(skip):
        return C.total_costs(lambda: A.blocked_attention(
            q, k, k, q_chunk=1024, kv_chunk=1024, causal_skip=skip))["flops"]

    full, skipped = flops(False), flops(True)
    assert full == 4 * 12 * 4096 * 4096 * 128
    assert skipped * 16 == full * 10
