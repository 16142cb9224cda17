"""M-RoPE in the port (``layers.apply_mrope`` and the M-RoPE branch of
``attention.attention_layer``) against the JAX package on the CPU: the
rotation at qwen2-vl's smoke sections (2, 3, 3) and full ones (16, 24,
24) on grid ids whose t, h and w differ; 2-D ids equal to their
broadcast to three (which is RoPE); and qwen2-vl's smoke attention
layer, a forward on grid ids and a block prefill into per-slot caches
followed by one decode step at each slot's position, at ``rtol=atol=
1e-5`` (the forwards' tolerance of ``test_torch_dense_configs.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_modality_parity as MP
import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.models import attention as A
from repro_torch.models import layers as L

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)],
                         ids=["smoke", "full"])
def test_apply_mrope_matches_jax(sections):
    d = 2 * sum(sections)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 3, d)).astype(np.float32)
    pos = MP.grid_ids(2, 64, width=8)
    pos[0, 1] += 5                          # a second frame in row 1
    ref = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections,
                        1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MP.TOL)
    # the three sections rotate differently: one id tensor for all three
    # gives another result
    one = L.apply_mrope(torch.as_tensor(x),
                        torch.as_tensor(pos[2]).expand(3, 2, 64), sections,
                        1e6)
    assert not torch.allclose(one, got)


def test_mrope_of_2d_ids_is_rope():
    """Ids broadcast to (3, B, S) rotate as RoPE on the (B, S) ids, bit
    for bit, as the reference's broadcast of 2-D ids assumes."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((2, 16, 2, 16)).astype(
        np.float32))
    pos = torch.as_tensor(rng.integers(0, 100, (2, 16)))
    assert torch.equal(L.apply_mrope(x, pos.expand(3, 2, 16), (2, 3, 3),
                                     1e6),
                       L.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(x, pos.expand(3, 2, 16), (2, 3, 4), 1e6)


def _attn():
    jcfg = MP.setup(MP.VLM)[0]
    cfg = REG.get_config(MP.VLM, smoke=True)
    pb = JL.ParamBuilder(jax.random.PRNGKey(4), "init", jnp.float32)
    jp = JA.init_attention(pb, "attn", jcfg)
    return jcfg, cfg, jp, from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def test_attention_layer_forward_matches_jax():
    """A causal forward on grid ids; 2-D ids give the same output as
    their broadcast to three."""
    jcfg, cfg, jp, tp = _attn()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = MP.grid_ids(2, 16)
    ref, _ = JA.attention_layer(jp, jnp.asarray(x), jcfg, RP.RULES,
                                positions=jnp.asarray(pos))
    got, _ = A.attention_layer(tp, torch.as_tensor(x), cfg,
                               positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MP.TOL)
    p2 = torch.as_tensor(pos[2])
    a, _ = A.attention_layer(tp, torch.as_tensor(x), cfg, positions=p2)
    b, _ = A.attention_layer(tp, torch.as_tensor(x), cfg,
                             positions=p2.expand(3, 2, 16))
    assert torch.equal(a, b)


def test_attention_layer_prefill_and_decode_match_jax():
    """A 10-token block prefill into per-slot caches of 14, then one
    decode token per slot at positions 10 and 6: its M-RoPE ids come
    from each slot's ``pos`` (all three sections at pos), as in the
    reference's decode."""
    jcfg, cfg, jp, tp = _attn()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jc = JA.init_kv_cache(jcfg, 2, 14, local=False, per_slot=True)
    tc = A.init_kv_cache(cfg, 2, 14, local=False, per_slot=True)
    jo, jc = JA.attention_layer(jp, jnp.asarray(x), jcfg, RP.RULES,
                                cache=jc)
    to, tc = A.attention_layer(tp, torch.as_tensor(x), cfg, cache=tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MP.TOL)
    # slot 1 decodes at position 6 (its cache rows past 6 unread)
    jc = {**jc, "pos": jnp.asarray([10, 6], jnp.int32)}
    tc["pos"].copy_(torch.tensor([10, 6]))
    jo, jc = JA.attention_layer(jp, jnp.asarray(xt), jcfg, RP.RULES,
                                cache=jc, decode=True)
    to, tc = A.attention_layer(tp, torch.as_tensor(xt), cfg, cache=tc,
                               decode=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MP.TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **MP.TOL)
