"""ResNet-style CNN of the paper's vision experiments (ResNet-18 on
CIFAR-10) with its SFL split, mirroring :mod:`repro.models.cnn`.

GroupNorm stands in for BatchNorm, as in the JAX package, so the model
carries no running state.  The client holds the stem (conv-norm-relu)
and the first ``client_blocks`` residual blocks; the aux head is one
pooled fully-connected layer; the server holds the rest.

Layouts are the JAX package's: NHWC activations and HWIO conv weights,
so the tree paths (which the per-leaf seeds hash) and the weights'
canonical 2-D noise views ``(kh*kw*cin, cout)`` are the same.  The clean
and server convs are ``torch.nn.functional.conv2d`` (XLA convs in the
JAX package, outside any kernel), permuted to NCHW / OIHW only at that
call and padded like XLA's SAME.  The ZO-perturbed convs lower onto the
ZO matmul kernels over im2col patches: K2 for the dual probe, K4 for the
single probe.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as O
from repro_torch.models.config import DTYPES
from repro_torch.models.layers import dense, init_param
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    widths: tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: int = 2
    classes: int = 10
    client_blocks: int = 1       # residual blocks on the client
    groups: int = 8
    param_dtype: str = "float32"
    forward_impl: str = "xla"    # xla | kernel: the threefry probe, or the
                                 # ZO perturbed client forward through the
                                 # dual-probe matmul kernel (im2col convs)

    def torch_param_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]


def _conv_init(gen, kh, kw, cin, cout, dtype):
    return init_param(gen, (kh, kw, cin, cout), dtype, "normal",
                      scale=math.sqrt(2.0 / (kh * kw * cin)))


def _gn_init(gen, c, dtype):
    return {"scale": init_param(gen, (c,), dtype, "ones"),
            "bias": init_param(gen, (c,), dtype, "zeros")}


def _same_pad(size: int, k: int, stride: int):
    """XLA's SAME padding: output ``ceil(size / stride)``, total padding
    split ``lo = pad // 2`` (so (0, 1) for a 3x3 conv at stride 2 on an
    even size, where ``F.conv2d``'s symmetric padding would give (1, 1))."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return out, pad // 2, pad - pad // 2


def conv(w, x, stride=1):
    """SAME conv, x (B, H, W, C) NHWC, w (kh, kw, cin, cout) HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    _, ph0, ph1 = _same_pad(x.shape[1], kh, stride)
    _, pw0, pw1 = _same_pad(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def groupnorm(p, x, groups=8, eps=1e-5):
    """GroupNorm over NHWC: f32 statistics, population variance."""
    B, H, W, C = x.shape
    g = min(groups, C)
    xg = x.reshape(B, H, W, g, C // g).to(torch.float32)
    mu = torch.mean(xg, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xg, dim=(1, 2, 4), keepdim=True, correction=0)
    xn = ((xg - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (xn * p["scale"] + p["bias"]).to(x.dtype)


def _block_init(gen, cin, cout, stride, dtype):
    p = {"c1": _conv_init(gen, 3, 3, cin, cout, dtype),
         "n1": _gn_init(gen, cout, dtype),
         "c2": _conv_init(gen, 3, 3, cout, cout, dtype),
         "n2": _gn_init(gen, cout, dtype)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, dtype)
    return p


def _im2col(x, kh, kw, stride):
    """SAME-padded patches: (B, H, W, C) -> (B, Ho, Wo, kh*kw*C) with
    patch channel order (i, j, c), the linearization of an HWIO weight's
    leading axes, so ``patches @ w.reshape(kh*kw*cin, cout)`` is the conv
    and the weight's canonical 2-D noise field applies unchanged."""
    _, H, W, _ = x.shape
    ho, ph0, ph1 = _same_pad(H, kh, stride)
    wo, pw0, pw1 = _same_pad(W, kw, stride)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    cols = [xp[:, i:i + (ho - 1) * stride + 1:stride,
               j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1), ho, wo


def conv_perturbed(w, x, stride, seed, perturb):
    """Conv with the ZO weight perturbation fused into the ZO matmul
    over im2col patches (a 1x1 conv at stride 1 is a plain reshaped
    matmul).  In dual mode the [clean; perturbed] halves ride the leading
    batch axis and one fused pass (K2) serves both; the single probe is
    one K4 pass."""
    kh, kw, cin, cout = w.shape
    if kh == kw == 1 and stride == 1:
        cols, ho, wo = x, x.shape[1], x.shape[2]
    else:
        cols, ho, wo = _im2col(x, kh, kw, stride)
    w2 = w.reshape(kh * kw * cin, cout).contiguous()
    x2 = cols.reshape(-1, kh * kw * cin)
    if perturb.dual:
        half = x2.shape[0] // 2
        ya, yb = O.zo_dual_matmul(x2[:half].contiguous(),
                                  x2[half:].contiguous(), w2, seed, 0.0,
                                  perturb.mu)
        y2 = torch.cat([ya, yb], dim=0)
    else:
        y2 = O.zo_matmul(x2.contiguous(), w2, seed, perturb.mu)
    return y2.reshape(x.shape[0], ho, wo, cout)


def _conv_maybe(w, x, stride, seed, perturb):
    if seed is None:
        return conv(w, x, stride)
    return conv_perturbed(w, x, stride, seed, perturb)


def _gn_maybe(p, x, groups, seeds, perturb):
    if perturb is None or not O.any_seed(seeds):
        return groupnorm(p, x, groups)
    pp = O.perturb_tree(p, seeds, perturb.mu)
    if not perturb.dual:
        return groupnorm(pp, x, groups)
    half = x.shape[0] // 2
    return torch.cat([groupnorm(p, x[:half], groups),
                      groupnorm(pp, x[half:], groups)], dim=0)


def _block_apply(p, x, stride, groups, perturb=None):
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    if perturb is None:
        h = F.relu(groupnorm(p["n1"], conv(p["c1"], x, stride), groups))
        h = groupnorm(p["n2"], conv(p["c2"], h), groups)
        sc = conv(p["proj"], x, stride) if "proj" in p else x
        return F.relu(h + sc)
    s = perturb.seeds
    h = _conv_maybe(p["c1"], x, stride, s.get("c1"), perturb)
    h = F.relu(_gn_maybe(p["n1"], h, groups, s.get("n1"), perturb))
    h = _gn_maybe(p["n2"], _conv_maybe(p["c2"], h, 1, s.get("c2"), perturb),
                  groups, s.get("n2"), perturb)
    sc = _conv_maybe(p["proj"], x, stride, s.get("proj"), perturb) \
        if "proj" in p else x
    return F.relu(h + sc)


def _stage_plan(cfg: CNNConfig):
    """[(stage, block_idx, cin, cout, stride)] flat block list."""
    plan = []
    cin = cfg.widths[0]
    for si, w in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            plan.append((si, bi, cin, w, stride))
            cin = w
    return plan


def init_cnn(cfg: CNNConfig, seed: int = 0, device="cuda"):
    """``{"client": ..., "server": ...}`` from a seeded random init, with
    the JAX package's tree paths and shapes.  The draws come from a CPU
    generator and then move to ``device``; on the ``meta`` device the
    leaves have shapes and dtypes alone."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator().manual_seed(seed)
    dt = cfg.torch_param_dtype()
    plan = _stage_plan(cfg)
    stem = {"conv": _conv_init(gen, 3, 3, 3, cfg.widths[0], dt),
            "norm": _gn_init(gen, cfg.widths[0], dt)}
    blocks = [_block_init(gen, cin, cout, stride, dt)
              for _, _, cin, cout, stride in plan]
    cb = cfg.client_blocks
    aux_in = plan[cb - 1][3] if cb else cfg.widths[0]
    client = {"stem": stem, "blocks": blocks[:cb],
              "aux": {"fc": {"w": init_param(gen, (aux_in, cfg.classes), dt),
                             "b": init_param(gen, (cfg.classes,), dt,
                                             "zeros")}}}
    server = {"blocks": blocks[cb:],
              "fc": {"w": init_param(gen, (cfg.widths[-1], cfg.classes), dt),
                     "b": init_param(gen, (cfg.classes,), dt, "zeros")}}
    return tree_map(lambda t: t.to(dev), {"client": client,
                                          "server": server})


def client_forward(client, x, cfg: CNNConfig, perturb=None):
    """x: (B, H, W, 3) -> smashed feature map.  With ``perturb`` the
    client pass is ZO-perturbed (convs lower onto the ZO matmul kernels
    through im2col); ``perturb.dual`` doubles the batch into [clean;
    perturbed] halves at entry."""
    if perturb is not None and not O.any_seed(perturb.seeds):
        perturb = None
    if perturb is not None and perturb.dual:
        x = torch.cat([x, x], dim=0)
    ps = O.psub(perturb, "stem")
    h = _conv_maybe(client["stem"]["conv"], x, 1,
                    None if ps is None else ps.seeds.get("conv"), perturb)
    h = F.relu(_gn_maybe(client["stem"]["norm"], h, cfg.groups,
                         None if ps is None else ps.seeds.get("norm"),
                         perturb))
    pblocks = O.psub(perturb, "blocks")
    for i, (p, (_, _, _, _, stride)) in enumerate(zip(client["blocks"],
                                                      _stage_plan(cfg))):
        h = _block_apply(p, h, stride, cfg.groups, O.psub(pblocks, i))
    return h


def aux_logits(client, smashed, cfg: CNNConfig, perturb=None):
    pooled = torch.mean(smashed, dim=(1, 2))
    fc = client["aux"]["fc"]
    pf = O.psub(O.psub(perturb, "aux"), "fc")
    if pf is not None:
        return dense(fc, pooled.to(torch.float32), torch.float32, pf)
    return pooled.to(torch.float32) @ fc["w"].to(torch.float32) \
        + fc["b"].to(torch.float32)


def server_logits(server, smashed, cfg: CNNConfig):
    h = smashed
    for p, (_, _, _, _, stride) in zip(server["blocks"],
                                       _stage_plan(cfg)[cfg.client_blocks:]):
        h = _block_apply(p, h, stride, cfg.groups)
    pooled = torch.mean(h, dim=(1, 2))
    fc = server["fc"]
    return pooled.to(torch.float32) @ fc["w"].to(torch.float32) \
        + fc["b"].to(torch.float32)


def xent(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
