"""The port's optimizers, schedules, whole-model forward and LoRA against
the JAX package: Adafactor (factored and not, with and without weight
decay, a callable lr) over 3 steps, every ``make_optimizer`` name,
``clip_by_global_norm``, the three learning-rate schedules over a range
of steps, ``transformer.full_forward`` on gpt2-tiny, and ``merge_lora`` /
``lora_pred`` on JAX's adapters; ``add_lora``'s shapes, scale and zero
``lora_b``.  Inputs from numpy seeds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.models import lora as JLORA
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro.optim import schedules as JSCH
from repro_torch.bridge import from_jax
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.models import lora as LORA
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.optim import schedules as SCH
from repro_torch.tree import tree_leaves, tree_leaves_with_path

# f32 elementwise maths; XLA and torch round pow, rsqrt and the row /
# column means apart by an ulp or two, which a few steps carry
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_model.py's


def _tree(seed):
    """A 2-D, a stacked 3-D and a 1-D leaf (factored and not)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": [rng.standard_normal((2, 4, 3)).astype(np.float32)],
            "b": rng.standard_normal((5,)).astype(np.float32)}


def _run(jopt, opt, steps=3):
    """``steps`` updates of each side from the same params and grads;
    returns both params trees."""
    jp = _tree(0)
    tp = jax.tree.map(torch.as_tensor, jp)
    js, ts = jopt.init(jp), opt.init(tp)
    for s in range(steps):
        g = _tree(100 + s)
        jp, js = jax.jit(jopt.update)(g, js, jp)
        tp, ts = opt.update(jax.tree.map(torch.as_tensor, g), ts, tp)
    return RP.leaves(tp), jax.tree.leaves(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["const", "callable"])
def test_adafactor_matches_jax(lr, wd):
    jlr = 1e-2 if lr == "const" else (lambda s: 1e-2 / (1.0 + s))
    tlr = 1e-2 if lr == "const" else (lambda s: 1e-2 / (1.0 + s))
    got, want = _run(JOPT.adafactor(jlr, weight_decay=wd),
                     OPT.adafactor(tlr, weight_decay=wd))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **OPT_TOL)


def test_adafactor_state_is_factored():
    st = OPT.adafactor(1e-2).init(jax.tree.map(torch.as_tensor, _tree(0)))
    assert set(st["v"]["w"]) == {"vr", "vc"}
    assert st["v"]["w"]["vr"].shape == (6,) and st["v"]["w"]["vc"].shape == (
        5,)
    assert st["v"]["stack"][0]["vr"].shape == (2, 4)
    assert st["v"]["stack"][0]["vc"].shape == (2, 3)
    assert set(st["v"]["b"]) == {"v"} and st["v"]["b"]["v"].shape == (5,)


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw", "adam",
                                  "adafactor", "zo_sgd"])
def test_make_optimizer_matches_jax(name):
    got, want = _run(JOPT.make_optimizer(name, 1e-2),
                     OPT.make_optimizer(name, 1e-2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **OPT_TOL)
    with pytest.raises(KeyError):
        OPT.make_optimizer("lamb", 1e-2)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(7)
    g["half"] = np.float32([3.0, -4.0])
    tg = jax.tree.map(torch.as_tensor, g)
    tg["half"] = tg["half"].to(torch.bfloat16)
    jg = dict(g, half=jnp.asarray(g["half"], jnp.bfloat16))
    clipped, nrm = OPT.clip_by_global_norm(tg, max_norm)
    jclipped, jnrm = JOPT.clip_by_global_norm(jg, max_norm)
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-6)
    assert clipped["half"].dtype == torch.float32       # promoted, as JAX
    assert jclipped["half"].dtype == jnp.float32
    for a, b in zip(RP.leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    total = math.sqrt(sum(float((t.double() ** 2).sum())
                          for t in tree_leaves(clipped)))
    assert total == pytest.approx(min(max_norm, float(nrm)), rel=1e-5)


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4)),
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-3, 10, 50)),
    "warmup_cosine_frac": (lambda m: m.warmup_cosine(2e-3, 0, 7, 0.3)),
    "linear_decay": (lambda m: m.linear_decay(1e-3, 40)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    fn, jfn = SCHEDULES[name](SCH), SCHEDULES[name](JSCH)
    for step in range(0, 61):
        got = fn(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = jfn(jnp.int32(step))          # the optimizers' step type
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12)


def test_schedule_drives_an_optimizer():
    got, want = _run(JOPT.adamw(JSCH.warmup_cosine(1e-2, 2, 5)),
                     OPT.adamw(SCH.warmup_cosine(1e-2, 2, 5)), steps=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **OPT_TOL)


@pytest.fixture(scope="module")
def lm():
    p = JT.init_lm(jax.random.PRNGKey(0), jax_gpt2_tiny())
    return jax.tree.map(np.asarray, p)


def _tokens(b=2, s=16, seed=3):
    return np.random.default_rng(seed).integers(0, jax_gpt2_tiny().vocab,
                                                (b, s))


def test_full_forward_matches_jax(lm):
    toks = _tokens()
    want = JT.full_forward(lm, jax_gpt2_tiny(), RP.RULES, toks)
    got = T.full_forward(from_jax(lm, device="cpu"), gpt2_tiny(),
                         torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _jax_lora(lm):
    lp = JLORA.add_lora(jax.random.PRNGKey(2), lm, rank=4)
    # nonzero lora_b, so the merge moves the weights
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if "lora_b" in jax.tree_util.keystr(path)
        else x, jax.tree.map(np.asarray, lp))


def test_merge_lora_matches_jax(lm):
    lp = jax.tree.map(np.asarray, _jax_lora(lm))
    got = LORA.merge_lora(from_jax(lp, device="cpu"))
    want = JLORA.merge_lora(lp)
    assert not any(LORA.lora_pred(p) for p, _ in tree_leaves_with_path(got))
    for a, b in zip(RP.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    # the adapted model's forward equals the merged one's, on both sides
    toks = _tokens()
    y = T.full_forward(from_jax(lp, device="cpu"), gpt2_tiny(),
                       torch.as_tensor(toks))
    ym = T.full_forward(got, gpt2_tiny(), torch.as_tensor(toks))
    np.testing.assert_allclose(y.numpy(), ym.numpy(), **FWD_TOL)
    jy = JT.full_forward(lp, jax_gpt2_tiny(), RP.RULES, toks)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD_TOL)


def test_lora_pred_matches_jax(lm):
    lp = _jax_lora(lm)
    paths = [p for p, _ in tree_leaves_with_path(from_jax(lp, device="cpu"))]
    assert any(LORA.lora_pred(p) for p in paths)
    for p in paths + ["a/lora_a", "lora_b", "w", "attn/wq/w"]:
        assert LORA.lora_pred(p) == JLORA.lora_pred(p)


def test_add_lora_shapes_scale_and_zero_b(lm):
    params = from_jax(lm, device="cpu")
    rank, alpha = 4, 16.0
    out = LORA.add_lora(torch.Generator().manual_seed(0), params, rank,
                        alpha)
    jout = JLORA.add_lora(jax.random.PRNGKey(2), lm, rank, alpha)
    got = {p: t for p, t in tree_leaves_with_path(out)}
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(jout)[0]}
    assert set(got) == set(want)
    n_a = 0
    for p, t in got.items():
        assert tuple(t.shape) == tuple(want[p].shape), p
        assert t.dtype == torch.float32
        if p.endswith("lora_b"):
            assert not t.any()
        elif p.endswith("lora_a"):
            n_a += 1
            d_in = t.shape[-2]
            std = float(t.std())
            assert 0.7 < std / ((alpha / rank) / d_in ** 0.5) < 1.3, p
    assert n_a > 0
    # an adapted model computes the base model at init
    toks = torch.as_tensor(_tokens())
    np.testing.assert_allclose(
        T.full_forward(out, gpt2_tiny(), toks).numpy(),
        T.full_forward(params, gpt2_tiny(), toks).numpy(), **FWD_TOL)
