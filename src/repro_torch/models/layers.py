"""Core layers: param init, norms, dense (plain and ZO-perturbed),
embeddings, RoPE and M-RoPE, MLP, the depthwise causal conv1d of the
RG-LRU block.  Plain functions on nested dicts of tensors, mirroring
:mod:`repro.models.layers`.

Init functions draw from an explicit ``torch.Generator``; given None
they make shape-only tensors on the ``meta`` device, and given
:data:`RULES` each leaf's :class:`InitRule`.  The generator's draws are
not the JAX package's; :func:`repro_torch.models.transformer.init_lm`
with a ``key`` draws the rules on JAX's key stream
(:func:`jax_init_leaf`), and parity tests load the JAX params through
:func:`repro_torch.bridge.from_jax`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import prng as R
from repro_torch.kernels import ops as O


class InitRule:
    """A leaf's init rule as an init function states it: what
    :func:`init_param` returns given :data:`RULES` in place of a
    generator, so one tree of rules is drawn on another stream
    (:func:`jax_init_leaf`).  ``reps`` > 0: a stacked leaf
    (:func:`stack_leaves`), ``reps`` draws of ``shape``."""

    def __init__(self, shape, dtype, init, scale, reps=0):
        self.shape, self.dtype, self.init = shape, dtype, init
        self.scale, self.reps = scale, reps


RULES = object()       # init_param's "generator" that returns InitRules


def _draw(shape, dtype, init, scale, device, uniform, normal):
    """One leaf under its init rule; ``uniform(lo, hi)`` and ``normal()``
    draw f32 of ``shape`` on the stream at hand."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "lru_lambda":
        # RG-LRU Lambda: a uniform in a stable band, parametrized via
        # softplus^{-1}(-log(a)/c) with c=8
        a = -torch.log(uniform(0.9, 0.999)) * 8.0
        return torch.log(torch.expm1(a)).to(dtype)
    if init != "normal":
        raise ValueError(init)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (scale * normal()).to(dtype)


def init_param(gen: torch.Generator, shape, dtype, init="normal",
               scale=None):
    """One leaf, drawn on ``gen``'s device (``gen=None``: an empty
    tensor on the ``meta`` device, its shape and dtype alone;
    ``gen=RULES``: its :class:`InitRule`)."""
    shape = tuple(int(s) for s in shape)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    if gen is RULES:
        return InitRule(shape, dtype, init, scale)
    dev = gen.device
    return _draw(shape, dtype, init, scale, dev,
                 lambda lo, hi: lo + (hi - lo) * torch.rand(
                     shape, generator=gen, dtype=torch.float32, device=dev),
                 lambda: torch.randn(shape, generator=gen,
                                     dtype=torch.float32, device=dev))


def stack_leaves(xs):
    """The reps of a stacked leaf: tensors stacked, rules counted."""
    if isinstance(xs[0], InitRule):
        return InitRule(xs[0].shape, xs[0].dtype, xs[0].init, xs[0].scale,
                        len(xs))
    return torch.stack(xs)


def jax_init_leaf(key, path: str, rule: InitRule, device="cpu"):
    """The JAX package's ``ParamBuilder.param`` draw of one leaf (one rep
    of a stacked one) under its rule: under ``fold_in(key,
    path_hash(path))`` (its ``_path_seed`` is the same FNV-1a hash, of the
    '.'-joined init path), in f32, cast to the rule's dtype.  The normals
    are within a few f32 ulps of JAX's (:func:`repro_torch.core.prng.
    normal`), the uniforms bit for bit."""
    shape = rule.shape
    k = lambda: R.fold_in(key, O.path_hash(path))  # noqa: E731
    return _draw(shape, rule.dtype, rule.init, rule.scale, device,
                 lambda lo, hi: R.uniform(k(), shape, lo, hi, device=device),
                 lambda: R.normal(k(), shape, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(gen, dim: int, dtype):
    return {"scale": init_param(gen, (dim,), dtype, "zeros")}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale); "zeros" init => identity at init
    return (y * (1.0 + params["scale"].to(torch.float32))).to(dt)


def init_layernorm(gen, dim: int, dtype):
    return {"scale": init_param(gen, (dim,), dtype, "ones"),
            "bias": init_param(gen, (dim,), dtype, "zeros")}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def init_dense(gen, d_in: int, d_out: int, dtype, bias: bool = False,
               scale=None):
    p = {"w": init_param(gen, (d_in, d_out), dtype, "normal", scale)}
    if bias:
        p["b"] = init_param(gen, (d_out,), dtype, "zeros")
    return p


def dense(params, x, compute_dtype=None, perturb=None):
    if perturb is not None and O.any_seed(perturb.seeds):
        return _dense_perturbed(params, x, perturb, compute_dtype)
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "lora_a" in params:  # low-rank adapter branch (pre-scaled at init)
        y = y + (x @ params["lora_a"].to(x.dtype)) \
            @ params["lora_b"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _dense_perturbed(params, x, perturb, compute_dtype=None):
    """Dense with the ZO perturbation fused into the matmul.  In dual
    mode the activations carry [clean; perturbed] halves along the
    leading axis and one read of W serves both (kernel K2 on the card);
    in single-probe mode the whole batch sees ``W + mu*U`` (kernel K4).
    ``perturb.rep`` row-offsets the noise of a slice of a stacked leaf."""
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    seeds = perturb.seeds if isinstance(perturb.seeds, dict) else {}
    mu, rep, dual = perturb.mu, perturb.rep, perturb.dual
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])   # batch axis leads: rows [0, M/2)
    half = x2.shape[0] // 2           # of the dual stack are the clean half
    off = int(rep) * w.shape[0]
    sw = seeds.get("w")
    if sw is None:
        y2 = x2 @ w
    elif dual:
        ya, yb = O.zo_dual_matmul(x2[:half].contiguous(),
                                  x2[half:].contiguous(), w.contiguous(),
                                  sw, 0.0, mu, row_offset=off)
        y2 = torch.cat([ya, yb], dim=0)
    else:
        y2 = O.zo_matmul(x2.contiguous(), w.contiguous(), sw, mu,
                         row_offset=off)

    if "lora_a" in params:
        la = params["lora_a"].to(x2.dtype)
        lb = params["lora_b"].to(x2.dtype)
        lap = O.perturb_tree(la, seeds.get("lora_a"), mu, rep)
        lbp = O.perturb_tree(lb, seeds.get("lora_b"), mu, rep)
        if dual:
            y2 = y2 + torch.cat([(x2[:half] @ la) @ lb,
                                 (x2[half:] @ lap) @ lbp], dim=0)
        else:
            y2 = y2 + (x2 @ lap) @ lbp
    if "b" in params:
        b = params["b"]
        bp = O.perturb_tree(b, seeds.get("b"), mu, rep)
        if dual:
            y2 = y2 + torch.cat(
                [b.to(y2.dtype).expand(half, b.shape[-1]),
                 bp.to(y2.dtype).expand(y2.shape[0] - half, b.shape[-1])],
                dim=0)
        else:
            y2 = y2 + bp.to(y2.dtype)
    return y2.reshape(tuple(lead) + (w.shape[1],))


def norm_apply(norm_fn, params, x, perturb=None):
    """Apply a norm with optionally ZO-perturbed scale/bias; in dual mode
    only the perturbed half of the activation stack sees the noise."""
    if perturb is None or not O.any_seed(perturb.seeds):
        return norm_fn(params, x)
    pp = O.perturb_tree(params, perturb.seeds, perturb.mu, perturb.rep)
    if not perturb.dual:
        return norm_fn(pp, x)
    half = x.shape[0] // 2
    return torch.cat([norm_fn(params, x[:half]), norm_fn(pp, x[half:])],
                     dim=0)


def init_embedding(gen, vocab: int, dim: int, dtype):
    return {"table": init_param(gen, (vocab, dim), dtype, "normal", 0.02)}


def embed(params, ids, compute_dtype):
    return params["table"].to(compute_dtype)[ids]


def unembed(params, x, compute_dtype):
    return x.to(compute_dtype) @ params["table"].to(compute_dtype).T


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rope_angles(positions, head_dim: int, theta: float):
    # positions: (..., S); returns (..., S, head_dim//2)
    return positions[..., None].to(torch.float32) * _rope_freqs(
        head_dim // 2, theta, positions.device)


def _rotate(x, ang):
    """x: (B, S, H, D) rotated in f32 by the (B, S, D/2) angles ``ang``,
    its two halves as the pairs."""
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x, positions3, sections, theta: float = 1e6):
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions3: (3, B, S)
    temporal / height / width position ids.  ``sections`` partitions the
    half-dim: frequency index ``i`` of section ``j`` rotates with
    ``positions3[j]``, at the angles of :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    sel = torch.cat([torch.full((s,), j, dtype=torch.long)
                     for j, s in enumerate(sections)]).to(x.device)
    pos_half = torch.movedim(positions3.to(torch.float32)[sel], 0, -1)
    return _rotate(x, pos_half * _rope_freqs(half, theta, x.device))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False):
    p = {"up": init_dense(gen, d_model, d_ff, dtype, bias),
         "down": init_dense(gen, d_ff, d_model, dtype, bias)}
    if gated:
        p["gate"] = init_dense(gen, d_model, d_ff, dtype, bias)
    return p


def _act(x, activation: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if activation == "silu" else F.gelu(x,
                                                        approximate="tanh")


def mlp(params, x, activation: str = "silu", compute_dtype=None,
        perturb=None):
    up = dense(params["up"], x, compute_dtype, O.psub(perturb, "up"))
    if "gate" in params:
        g = dense(params["gate"], x, compute_dtype, O.psub(perturb, "gate"))
        h = _act(g, activation) * up
    else:
        h = _act(up, activation)
    return dense(params["down"], h, compute_dtype, O.psub(perturb, "down"))


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the RG-LRU block's)
# ---------------------------------------------------------------------------

def init_conv1d(gen, dim: int, dtype, width: int = 4):
    return {"w": init_param(gen, (width, dim), dtype, "normal", 0.1),
            "b": init_param(gen, (dim,), dtype, "zeros")}


def causal_conv1d(params, x, state=None):
    """x: (B, S, C) depthwise causal conv over the sequence, in x's
    dtype.  With ``state``, the (B, width-1, C) trailing context of the
    tokens before x, it runs in streaming mode and returns ``(out,
    new_state)``."""
    w = params["w"].to(x.dtype)                       # (width, C)
    width = w.shape[0]
    if state is not None:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        ctx = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + ctx[:, i:i + x.shape[1], :] * w[i]
    out = out + params["b"].to(x.dtype)
    if state is not None:
        return out, (ctx[:, -(width - 1):, :] if width > 1 else state)
    return out


def softcap(x, cap):
    if cap is None or cap <= 0:
        return x
    return cap * torch.tanh(x / cap)
