"""Activation checkpointing in the port (``ModelConfig.remat``;
``transformer.apply_stack``), on the CPU:

* one datacenter step (``make_train_step``, f32 smoke configs, one numpy
  batch) with remat on equals the step with remat off bit for bit: the
  loss and metrics, every gradient the step takes (each
  ``protocols._value_and_grad`` result: FSL-SAGE's alignment gradient
  through the double backward of the aux block included) and the
  updated state.  The cases cover the server stack (gpt2-tiny HERON),
  the aux-head clients (CSE-FSL, FSL-SAGE), the training lock (SFLV2),
  the RG-LRU (K6's plain version), xLSTM, the MoE and seamless's
  decoder, whose blocks read ``enc_out`` as an argument of the
  checkpointed rep.  Each case counts its checkpoint frames: one a rep of every stack the step differentiates;
* on ``meta`` tensors ``launch/costs.total_costs`` of a 4-layer HERON
  step: remat lowers the tracked peak and adds the server stack's
  forward FLOPs but one product a block (the recompute stops at its last
  saved tensor, the input of the MLP's down projection, as XLA drops the
  dead product from the reference's replay);
* no checkpoint frame runs where autograd does not record or caches are
  written: HERON's ZO client forward (both streams), ``DecodeEngine``'s
  admission and decode, and the cached prefill and serve steps called
  with grad enabled.
"""
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from torch_round_parity import one_torch_thread  # noqa: F401
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.configs.registry import get_config
from repro_torch.core import decode as D
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.launch import costs as C
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves

B, S = 2, 16
# case -> (arch, method)
CASES = {"gpt2_heron": ("gpt2-tiny", "heron"),
         "gpt2_cse_fsl": ("gpt2-tiny", "cse_fsl"),
         "gpt2_fsl_sage": ("gpt2-tiny", "fsl_sage"),
         "gpt2_sflv2": ("gpt2-tiny", "sflv2"),
         "recurrentgemma_cse_fsl": ("recurrentgemma-9b", "cse_fsl"),
         "xlstm_cse_fsl": ("xlstm-1.3b", "cse_fsl"),
         "moe_cse_fsl": ("qwen3-moe-30b-a3b", "cse_fsl"),
         "seamless_heron": ("seamless-m4t-medium", "heron")}


def _config(arch):
    return gpt2_tiny() if arch == "gpt2-tiny" else get_config(arch, True)


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))
    if cfg.frontend is None:
        return {"inputs": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
                "labels": labels}
    out = {"inputs": torch.as_tensor(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)), "labels": labels}
    if cfg.enc_dec:
        out["dec_tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                         (B, S)))
        out["aux_labels"] = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                         (B, S)))
    return out


def _reps(specs):
    return sum(reps for _, reps in T.build_segments(specs))


def _frames(cfg, method):
    """The checkpoint frames of one step: a rep of every stack autograd
    records through (the server's forward twice in FSL-SAGE: its loss,
    then its cut-layer gradient for the alignment, with the aux head's
    forward again)."""
    server = _reps(T.server_specs(cfg)) + (
        _reps(T.decoder_specs(cfg)) if cfg.enc_dec else 0)
    client, aux = _reps(T.client_specs(cfg)), _reps(T.aux_specs(cfg))
    return {"heron": server, "cse_fsl": client + aux + server,
            "fsl_sage": client + 2 * aux + 2 * server,
            "sflv2": client + server}[method]


@pytest.fixture
def frames(monkeypatch):
    """Counts ``torch.utils.checkpoint.checkpoint`` calls."""
    n = [0]
    ckpt = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        n[0] += 1
        return ckpt(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    return n


def _step(cfg, method, monkeypatch):
    """One step from ``init_lm(seed=0)``: the flat list of its metrics,
    every ``_value_and_grad`` result (losses and gradients) and the new
    state's leaves."""
    got = []
    vg = P._value_and_grad

    def recorded(*a, **kw):
        out = vg(*a, **kw)
        got.append(out)
        return out

    monkeypatch.setattr(P, "_value_and_grad", recorded)
    copt = (OPT.zo_sgd(1e-3) if method == "heron"
            else OPT.adamw(1e-4, eps=1e-6))
    sopt = OPT.adamw(1e-4, eps=1e-6)
    state = P.init_train_state(R.PRNGKey(1), T.init_lm(cfg, seed=0,
                                                       device="cpu"),
                               copt, sopt)
    step = P.make_train_step(P.lm_api(cfg), method, Z.ZOConfig(mu=1e-2),
                             copt, sopt)
    new, m = step(state, _batch(cfg))
    monkeypatch.setattr(P, "_value_and_grad", vg)
    return list(m.values()) + tree_leaves(got) + tree_leaves(new)


def _bit_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.is_tensor(x):
            assert x == y, (i, x, y)
        else:
            assert torch.equal(x, y), (i, (x - y).abs().max())


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_equals_remat_off(case, frames, monkeypatch):
    arch, method = CASES[case]
    cfg = _config(arch)
    assert cfg.remat
    off = _step(cfg.replace(remat=False), method, monkeypatch)
    assert frames[0] == 0
    on = _step(cfg, method, monkeypatch)
    assert frames[0] == _frames(cfg, method) > 0
    _bit_equal(on, off)


def test_remat_lowers_the_tracked_peak_and_adds_the_recompute():
    cfg = get_config("qwen2-1.5b", smoke=True)
    Bm, Sm = 4, 32
    tok = torch.empty((Bm, Sm), dtype=torch.int32, device="meta")
    costs = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        copt, sopt = OPT.zo_sgd(1e-3), OPT.adamw(1e-3)
        state = P.init_train_state(R.PRNGKey(1), T.init_lm(c, device="meta"),
                                   copt, sopt)
        step = P.make_train_step(P.lm_api(c), "heron", Z.ZOConfig(mu=1e-3),
                                 copt, sopt)
        costs[remat] = C.total_costs(step, state, {"inputs": tok,
                                                   "labels": tok})
    params = T.init_lm(cfg, device="meta")
    x = torch.empty((Bm, Sm, cfg.d_model), dtype=cfg.torch_compute_dtype(),
                    device="meta")
    with torch.no_grad():
        fwd = C.total_costs(lambda: T.apply_stack(
            params["server"]["layers"], x, cfg, T.server_specs(cfg)))
    n_server = len(T.server_specs(cfg))
    down = 2 * Bm * Sm * cfg.d_ff * cfg.d_model
    assert n_server > 1
    assert costs[True]["flops"] - costs[False]["flops"] == \
        fwd["flops"] - n_server * down > 0
    assert costs[True]["peak_bytes"] < costs[False]["peak_bytes"]
    assert costs[True]["argument_bytes"] == costs[False]["argument_bytes"]


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_no_checkpoint_in_the_heron_client_forward(impl, frames):
    cfg = gpt2_tiny().replace(forward_impl=impl)
    api = P.lm_api(cfg)
    cp = T.init_lm(cfg, seed=0, device="cpu")["client"]
    opt = OPT.zo_sgd(1e-3)
    update = P.make_local_update(api, "heron", Z.ZOConfig(mu=1e-2), opt)
    seed = 1234 if impl == "kernel" else R.PRNGKey(3)
    with torch.enable_grad():
        update(cp, opt.init(cp), _batch(cfg), seed)
    assert frames[0] == 0


def test_no_checkpoint_in_serving(frames):
    cfg = gpt2_tiny()
    params = T.init_lm(cfg, seed=0, device="cpu")
    eng = D.DecodeEngine(params, cfg, slots=2, capacity=24, segment_len=4,
                         device="cpu")
    rng = np.random.default_rng(5)
    rids = [eng.submit(rng.integers(0, cfg.vocab, size=n), 4)
            for n in (5, 7, 6)]
    out = eng.run()
    assert all(len(out[r]) == 4 for r in rids)
    with torch.enable_grad():
        caches = P.init_serve_caches(cfg, 1, 24, device="cpu")
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 6)))
        logits, caches = P.make_cached_prefill_step(cfg)(params, caches, tok)
        P.make_serve_step(cfg)(params, caches, tok[:, :1])
    assert frames[0] == 0
