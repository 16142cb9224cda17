"""Core layers: param init, norms, dense (plain and ZO-perturbed),
embeddings, RoPE and M-RoPE, MLP, the depthwise causal conv1d of the
RG-LRU block.  Plain functions on nested dicts of tensors, mirroring
:mod:`repro.models.layers`.

Init functions draw from an explicit ``torch.Generator``; given None
they make shape-only tensors on the ``meta`` device, and given
:data:`RULES` each leaf's :class:`InitRule`, which carries the leaf's
logical axes (the reference's ``ParamBuilder`` in ``mode="axes"``).  The
generator's draws are not the JAX package's;
:func:`repro_torch.models.transformer.init_lm` with a ``key`` draws the
rules on JAX's key stream (:func:`jax_init_leaf`), and parity tests load
the JAX params through :func:`repro_torch.bridge.from_jax`.

Under a mesh with a "model" axis (``tp``, a :class:`DenseTP`) a dense
layer is column-parallel (its W a column slab, the input entering
through ``copy_to``) or row-parallel (a row slab, the partial products
summed by ``reduce_from``); its ZO noise reads the slab's global
coordinates.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import prng as R
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops as O


class InitRule:
    """A leaf's init rule as an init function states it: what
    :func:`init_param` returns given :data:`RULES` in place of a
    generator, so one tree of rules is drawn on another stream
    (:func:`jax_init_leaf`).  ``reps`` > 0: a stacked leaf
    (:func:`stack_leaves`), ``reps`` draws of ``shape``."""

    def __init__(self, shape, dtype, init, scale, reps=0, axes=None):
        self.shape, self.dtype, self.init = shape, dtype, init
        self.scale, self.reps = scale, reps
        self.axes = tuple(axes) if axes is not None else (None,) * len(shape)


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
               scale=None, axes=None):
    """One leaf, drawn on ``gen``'s device (``gen=None``: an empty
    tensor on the ``meta`` device, its shape and dtype alone;
    ``gen=RULES``: its :class:`InitRule`, with the logical ``axes``)."""
    shape = tuple(int(s) for s in shape)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    if gen is RULES:
        return InitRule(shape, dtype, init, scale, axes=axes)
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
                        len(xs), xs[0].axes)
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
    return {"scale": init_param(gen, (dim,), dtype, "zeros",
                                axes=("d_model",))}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale); "zeros" init => identity at init
    return (y * (1.0 + params["scale"].to(torch.float32))).to(dt)


def init_layernorm(gen, dim: int, dtype):
    return {"scale": init_param(gen, (dim,), dtype, "ones",
                                axes=("d_model",)),
            "bias": init_param(gen, (dim,), dtype, "zeros",
                               axes=("d_model",))}


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
               scale=None, axes=(None, None)):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}``; ``axes`` the logical
    names of W's two dims (the bias takes the second)."""
    p = {"w": init_param(gen, (d_in, d_out), dtype, "normal", scale,
                         axes=axes)}
    if bias:
        p["b"] = init_param(gen, (d_out,), dtype, "zeros", axes=axes[1:])
    return p


class DenseTP:
    """A dense layer's tensor-parallel layout on this rank, over
    ``mesh``'s "model" axis: ``mode`` ``"col"`` (W a column slab from
    global column ``col0``) or ``"row"`` (a row slab from global row
    ``row0``); ``rows`` is W's global row count.  :meth:`of` gives None
    where the rules leave W whole."""

    def __init__(self, mode, mesh, rows, row0=0, col0=0):
        self.mode, self.mesh = mode, mesh
        self.rows, self.row0, self.col0 = rows, row0, col0

    @classmethod
    def of(cls, rules, shape, axes):
        pl = None if rules is None else rules.sharding_for(shape, axes)
        if pl is None or not pl.sharded:
            return None
        (r0, _), (c0, _) = pl.bounds
        if pl.dim_axes(0) == ("model",) and not pl.dim_axes(1):
            return cls("row", rules.mesh, shape[0], row0=r0)
        if pl.dim_axes(1) == ("model",) and not pl.dim_axes(0):
            return cls("col", rules.mesh, shape[0], col0=c0)
        raise NotImplementedError(f"dense W {tuple(shape)} placed "
                                  f"{pl.spec}: only a column or a row slab "
                                  "on the model axis is a tensor-parallel "
                                  "layer")

    def window(self):
        """Where W's slab sits in the noise field of one layer."""
        return O.Window(self.rows, self.row0, self.col0)


def dense(params, x, compute_dtype=None, perturb=None, tp=None):
    """``x @ W (+ lora) (+ b)``; ``tp`` (a :class:`DenseTP`) makes it
    column- or row-parallel.  A column-parallel layer's input must have
    entered through ``copy_to`` (the caller's, once for all the layers
    that read it); a row-parallel layer sums its partial products with
    ``reduce_from`` before the bias, and its adapter's ``x @ lora_a``
    likewise before ``lora_b``."""
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if perturb is not None:
        y = _dense_perturbed(params, x, perturb, compute_dtype, tp)
    else:
        w = params["w"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        y = x @ w
    if tp is not None and tp.mode == "row":
        y = TP.reduce_from(y, tp.mesh)
    if "lora_a" in params:  # low-rank adapter branch (pre-scaled at init)
        y = y + _lora(params, x, perturb, tp)
    if "b" in params:
        b = params["b"]
        if perturb is not None:
            y = _bias_perturbed(b, y, perturb, tp)
        else:
            y = y + b.to(y.dtype)
    return y


def _dense_perturbed(params, x, perturb, compute_dtype=None, tp=None):
    """Dense with the ZO perturbation fused into the matmul.  In dual
    mode the activations carry [clean; perturbed] halves along the
    leading axis and one read of W serves both (kernel K2 on the card);
    in single-probe mode the whole batch sees ``W + mu*U`` (kernel K4).
    ``perturb.rep`` row-offsets the noise of a slice of a stacked leaf;
    ``tp`` places a slab of W at its global rows and columns."""
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    seeds = perturb.seeds if isinstance(perturb.seeds, dict) else {}
    mu, rep, dual = perturb.mu, perturb.rep, perturb.dual
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])   # batch axis leads: rows [0, M/2)
    half = x2.shape[0] // 2           # of the dual stack are the clean half
    win = O.Window(w.shape[0]) if tp is None else tp.window()
    off = int(rep) * win.rows + win.row0
    sw = seeds.get("w")
    if sw is None:
        y2 = x2 @ w
    elif dual:
        ya, yb = O.zo_dual_matmul(x2[:half].contiguous(),
                                  x2[half:].contiguous(), w.contiguous(),
                                  sw, 0.0, mu, row_offset=off,
                                  col_offset=win.col0)
        y2 = torch.cat([ya, yb], dim=0)
    else:
        y2 = O.zo_matmul(x2.contiguous(), w.contiguous(), sw, mu,
                         row_offset=off, col_offset=win.col0)
    return y2.reshape(tuple(lead) + (w.shape[1],))


def _lora(params, x, perturb, tp=None):
    """The adapter branch ``(x @ lora_a) @ lora_b`` (perturbed as the
    weight is: the dual stack's second half, or the whole single-probe
    batch, sees ``theta + mu*U`` of both factors).  A row-parallel
    layer's ``lora_a`` is a row slab whose partial products are summed
    before the whole ``lora_b``; a column-parallel layer's ``lora_b`` is
    a column slab, and its whole ``lora_a``, read for the rank's columns
    alone, enters through ``copy_to`` (its gradient summed over
    "model")."""
    la = params["lora_a"].to(x.dtype)
    lb = params["lora_b"].to(x.dtype)
    row = tp is not None and tp.mode == "row"
    if tp is not None and not row:
        la = TP.copy_to(la, tp.mesh)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if perturb is None:
        t = x2 @ la
        return ((TP.reduce_from(t, tp.mesh) if row else t) @ lb).reshape(
            tuple(lead) + (lb.shape[-1],))
    seeds = perturb.seeds if isinstance(perturb.seeds, dict) else {}
    mu, rep, half = perturb.mu, perturb.rep, x2.shape[0] // 2
    wa = tp.window() if row else None
    wb = None if tp is None or row else O.Window(lb.shape[-2], 0, tp.col0)
    lap = O.perturb_tree(la, seeds.get("lora_a"), mu, rep, wa)
    lbp = O.perturb_tree(lb, seeds.get("lora_b"), mu, rep, wb)
    if perturb.dual:
        t = torch.cat([x2[:half] @ la, x2[half:] @ lap], dim=0)
        if row:
            t = TP.reduce_from(t, tp.mesh)
        y = torch.cat([t[:half] @ lb, t[half:] @ lbp], dim=0)
    else:
        t = x2 @ lap
        y = (TP.reduce_from(t, tp.mesh) if row else t) @ lbp
    return y.reshape(tuple(lead) + (lb.shape[-1],))


def _bias_perturbed(b, y, perturb, tp=None):
    """``y + b`` with the bias perturbed as the weight is: the perturbed
    half of a dual stack (or the whole single-probe batch) adds ``b +
    mu*U``; a column slab's bias reads its global columns."""
    seeds = perturb.seeds if isinstance(perturb.seeds, dict) else {}
    mu, rep, dual = perturb.mu, perturb.rep, perturb.dual
    win = None if tp is None or tp.mode != "col" else O.Window(1, 0, tp.col0)
    lead = y.shape[:-1]
    y2 = y.reshape(-1, y.shape[-1])
    half = y2.shape[0] // 2
    bp = O.perturb_tree(b, seeds.get("b"), mu, rep, win)
    if dual:
        y2 = y2 + torch.cat(
            [b.to(y2.dtype).expand(half, b.shape[-1]),
             bp.to(y2.dtype).expand(y2.shape[0] - half, b.shape[-1])],
            dim=0)
    else:
        y2 = y2 + bp.to(y2.dtype)
    return y2.reshape(tuple(lead) + (y.shape[-1],))


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
    return {"table": init_param(gen, (vocab, dim), dtype, "normal", 0.02,
                                axes=("vocab", "d_model"))}


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

MLP_AXES = ("d_model", "d_ff")


def init_mlp(gen, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False):
    p = {"up": init_dense(gen, d_model, d_ff, dtype, bias, axes=MLP_AXES),
         "down": init_dense(gen, d_ff, d_model, dtype, bias,
                            axes=MLP_AXES[::-1])}
    if gated:
        p["gate"] = init_dense(gen, d_model, d_ff, dtype, bias,
                               axes=MLP_AXES)
    return p


def _act(x, activation: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if activation == "silu" else F.gelu(x,
                                                        approximate="tanh")


def mlp(params, x, activation: str = "silu", compute_dtype=None,
        perturb=None, rules=None, d_ff=None):
    """The (gated) MLP.  Under ``rules`` whose model axis splits the
    global ``d_ff``, up and gate are column-parallel (``x`` enters both
    through one ``copy_to``) and down row-parallel (one all-reduce)."""
    tp_in = tp_out = None
    if d_ff is not None:
        tp_in = DenseTP.of(rules, (x.shape[-1], d_ff), MLP_AXES)
        tp_out = DenseTP.of(rules, (d_ff, x.shape[-1]), MLP_AXES[::-1])
    if tp_in is not None:
        x = TP.copy_to(x, tp_in.mesh)
    up = dense(params["up"], x, compute_dtype, O.psub(perturb, "up"), tp_in)
    if "gate" in params:
        g = dense(params["gate"], x, compute_dtype, O.psub(perturb, "gate"),
                  tp_in)
        h = _act(g, activation) * up
    else:
        h = _act(up, activation)
    return dense(params["down"], h, compute_dtype, O.psub(perturb, "down"),
                 tp_out)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the RG-LRU block's)
# ---------------------------------------------------------------------------

def init_conv1d(gen, dim: int, dtype, width: int = 4):
    return {"w": init_param(gen, (width, dim), dtype, "normal", 0.1,
                            axes=("conv", "lru")),
            "b": init_param(gen, (dim,), dtype, "zeros", axes=("lru",))}


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
