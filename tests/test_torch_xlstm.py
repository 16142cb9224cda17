"""The port's xLSTM mixers (:mod:`repro_torch.models.recurrent`'s mLSTM and
sLSTM) against the JAX package's in f32 on the CPU: the sequential mLSTM
cell, the chunkwise-parallel one at chunks of 4 and 16 over a sequence
that is not a multiple of either (its padding path), the sLSTM cell, each
from a fresh and from a carried state; both blocks; a block prefill and
then one-token decode steps equal to the whole sequence (as
``tests/test_recurrent.py`` checks the reference); and the chunked
cell's gradient, finite where the reference's masked exp would overflow.
Inputs come from numpy seeds, params from the JAX init through the
bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from repro.distributed.sharding import AxisRules
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.bridge import from_jax
from repro_torch.models import recurrent as REC
from repro_torch.models.config import ModelConfig

jax.config.update("jax_platform_name", "cpu")

RULES = AxisRules(mesh=None)
B, S, H, DH = 2, 22, 4, 8          # S: not a multiple of 4 or 16
# The cells against JAX, as an absolute floor of ``x`` max |h|: torch's
# exp and log_sigmoid differ from XLA:CPU's by 1-2 ulps and the mLSTM
# divides by |n.q| (measured: the scan 6.4e-7, the chunked cell 6.9e-6
# at chunk 16, the sLSTM 2.1e-7, of max |h|).  The chunked form is the
# scan's exact reformulation, but its exp(a_s - M_t) weights span wider
# magnitudes: JAX's own chunk-16 and scan cells differ by 4.4e-6 of max
# |h| on these inputs.
SCAN_ATOL, CHUNK_ATOL, SLSTM_ATOL = 4e-6, 4e-5, 2e-6


def _cfg(cls, **kw):
    return cls(name="t", n_layers=1, d_model=H * DH, n_heads=H,
               n_kv_heads=H, d_ff=0, vocab=64, param_dtype="float32",
               compute_dtype="float32", **kw)


def _close(got, ref, atol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=atol * float(np.abs(ref).max()))


def _cell_inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, s, H, DH)).astype(np.float32)
           for _ in range(3)]
    gates = [(3 * rng.standard_normal((B, s, H))).astype(np.float32)
             for _ in range(2)]
    return qkv + gates


def _mlstm_state(carried):
    """None, or the JAX scan's state after 7 tokens of other inputs."""
    if not carried:
        return None, None
    _, st = JR._mlstm_cell_scan(*(jnp.asarray(a) for a in _cell_inputs(
        9, 7)))
    st = tuple(np.array(t) for t in st)
    return st, tuple(torch.as_tensor(t) for t in st)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_cell_scan_matches_jax(carried):
    ins = _cell_inputs(1)
    jst, tst = _mlstm_state(carried)
    hj, stj = JR._mlstm_cell_scan(*(jnp.asarray(a) for a in ins), jst)
    ht, stt = REC._mlstm_cell_scan(*(torch.as_tensor(a) for a in ins), tst)
    _close(ht, hj, SCAN_ATOL)
    for a, b in zip(stt, stj):
        _close(a, b, SCAN_ATOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_mlstm_cell_chunked_matches_jax_and_scan(chunk, carried):
    """Chunks of 4 and 16 over 22 tokens: both pad (22 % 4, 22 % 16).
    Against JAX's chunked cell and the port's own scan."""
    ins = _cell_inputs(2)
    jst, tst = _mlstm_state(carried)
    hj, stj = JR._mlstm_cell_chunked(*(jnp.asarray(a) for a in ins), jst,
                                     chunk)
    tin = [torch.as_tensor(a) for a in ins]
    ht, stt = REC._mlstm_cell_chunked(*tin, tst, chunk)
    assert ht.shape == (B, S, H, DH)
    _close(ht, hj, CHUNK_ATOL)
    for a, b in zip(stt, stj):
        _close(a, b, CHUNK_ATOL)
    hs, sts = REC._mlstm_cell_scan(*tin, tst)
    _close(ht, hs, CHUNK_ATOL)
    for a, b in zip(stt, sts):
        _close(a, b, CHUNK_ATOL)


def test_mlstm_chunked_gradient_finite_and_equal_to_scan():
    """Autograd through the chunked cell from the fresh state (m = -inf)
    over a padded sequence, with forget gates that make exp(a_s - M_t)
    overflow for s > t: finite, and the scan's gradient.  (The reference
    masks those weights after the exp; the port masks before it.)"""
    q, k, v, ig, fg = _cell_inputs(3)
    fg = fg - 8.0       # log_sigmoid ~ -8 a token: a_s - a_t > 88 at s - t > 11
    tin = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v, ig,
                                                             fg)]
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (B, S, H, DH)).astype(np.float32))
    h, _ = REC._mlstm_cell_chunked(*tin, None, 16)
    grads = torch.autograd.grad(torch.sum(h * g), tin)
    tin2 = [t.detach().clone().requires_grad_(True) for t in tin]
    h2, _ = REC._mlstm_cell_scan(*tin2)
    grads2 = torch.autograd.grad(torch.sum(h2 * g), tin2)
    for a, b in zip(grads, grads2):
        assert bool(torch.isfinite(a).all())
        _close(a, b, CHUNK_ATOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_slstm_cell_scan_matches_jax(carried):
    rng = np.random.default_rng(5)
    d = H * DH
    gx = rng.standard_normal((B, S, 4 * d)).astype(np.float32)
    r = (0.1 * rng.standard_normal((d, 4 * d))).astype(np.float32)
    jst = tst = None
    if carried:
        _, jst = JR._slstm_cell_scan(jnp.asarray(rng.standard_normal(
            (B, 5, 4 * d)).astype(np.float32)), jnp.asarray(r), d)
        jst = tuple(np.array(t) for t in jst)
        tst = tuple(torch.as_tensor(t) for t in jst)
    hj, stj = JR._slstm_cell_scan(jnp.asarray(gx), jnp.asarray(r), d, jst)
    ht, stt = REC._slstm_cell_scan(torch.as_tensor(gx), torch.as_tensor(r),
                                   tst)
    _close(ht, hj, SLSTM_ATOL)
    for a, b in zip(stt, stj):
        _close(a, b, SLSTM_ATOL)


def _block_params(kind):
    init = {"mlstm": JR.init_mlstm, "slstm": JR.init_slstm}[kind]
    pb = JL.ParamBuilder(jax.random.PRNGKey(0), "init", jnp.float32)
    jp = jax.tree.map(np.asarray, init(pb, kind, _cfg(JModelConfig)))
    return jp, from_jax(jp, device="cpu")


def _x(s=12, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, s, H * DH))).astype(np.float32)


@pytest.mark.parametrize("kind,chunk", [("mlstm", 0), ("mlstm", 4),
                                        ("slstm", 0)])
def test_block_matches_jax(kind, chunk):
    """The whole block and the state it ends in (``mlstm_chunk`` 4 takes
    the chunked cell over 12 tokens)."""
    jp, tp = _block_params(kind)
    jblock = {"mlstm": JR.mlstm_block, "slstm": JR.slstm_block}[kind]
    block = {"mlstm": REC.mlstm_block, "slstm": REC.slstm_block}[kind]
    init_s = {"mlstm": REC.init_mlstm_state,
              "slstm": REC.init_slstm_state}[kind]
    x = _x()
    jcfg = _cfg(JModelConfig, mlstm_chunk=chunk)
    cfg = _cfg(ModelConfig, mlstm_chunk=chunk)
    oj, sj = jblock(jp, jnp.asarray(x), jcfg, RULES)
    ot, _ = block(tp, torch.as_tensor(x), cfg)
    atol = CHUNK_ATOL if chunk else SCAN_ATOL
    _close(ot, oj, atol)
    # a block prefill writes the final state into a fresh one
    st = init_s(cfg, B)
    ot2, st = block(tp, torch.as_tensor(x), cfg, st)
    torch.testing.assert_close(ot2, ot, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(sj)):
        _close(a, b, atol)


@pytest.mark.parametrize("kind,chunk", [("mlstm", 0), ("mlstm", 4),
                                        ("slstm", 0)])
def test_prefill_then_decode_equals_full_sequence(kind, chunk):
    """A 5-token block prefill into a fresh state, then 7 one-token
    decode steps with slot 1 finished at the last two: slot 0's outputs
    equal the whole 12-token block's; slot 1's state stays as it was
    when it finished."""
    _, tp = _block_params(kind)
    block = {"mlstm": REC.mlstm_block, "slstm": REC.slstm_block}[kind]
    init_s = {"mlstm": REC.init_mlstm_state,
              "slstm": REC.init_slstm_state}[kind]
    cfg = _cfg(ModelConfig, mlstm_chunk=chunk)
    x = torch.as_tensor(_x())
    full, _ = block(tp, x, cfg)
    st = init_s(cfg, B)
    outs = [block(tp, x[:, :5], cfg, st)[0]]
    frozen = None
    for t in range(5, 12):
        live = torch.tensor([True, t < 10])
        if t == 10:
            frozen = [s[1].clone() for s in jax.tree.leaves(st)]
        outs.append(block(tp, x[:, t:t + 1], cfg, st, decode=True,
                          live=live)[0])
    stream = torch.cat(outs, dim=1)
    _close(stream[0], full[0], CHUNK_ATOL if chunk else SCAN_ATOL)
    _close(stream[1, :10], full[1, :10], CHUNK_ATOL if chunk else SCAN_ATOL)
    for s, f in zip(jax.tree.leaves(st), frozen):
        torch.testing.assert_close(s[1], f, rtol=0, atol=0)
