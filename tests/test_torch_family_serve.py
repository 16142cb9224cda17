"""Serving the xLSTM and MoE families: the port's ``DecodeEngine`` against
the JAX package's on the CPU (smoke configs, f32, greedy).  xlstm-1.3b
carries the mLSTM's (C, n, m) and conv states and the sLSTM's (c, n, h,
m) across admissions and slot recycling; qwen3-moe-30b-a3b runs 6 slots
with requests of different ``max_new``, so finished and empty slots
share decode steps with live ones.  Every slot of a decode step is
routed and competes for the experts' capacity, a finished one too, as
in the reference, and that capacity binds in some steps."""
import jax
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from torch_serve_parity import RULES, jax_config
from repro.core import decode as JD
from repro.models import transformer as JT
from repro_torch.bridge import from_jax
from repro_torch.configs import registry as REG
from repro_torch.core import decode as D
from repro_torch.models import moe as M

jax.config.update("jax_platform_name", "cpu")

# (prompt length, max_new) per request: mixed, so slots finish at
# different steps and are refilled while others decode
QUEUE = [(5, 9), (9, 3), (3, 12), (7, 5), (4, 2), (6, 10), (8, 7), (5, 4),
         (3, 6)]


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_engines():
    yield
    JD._FN_CACHE.clear()
    jax.clear_caches()


def _engines(jcfg, cfg, slots, queue, seed=0, segment_len=4, capacity=24):
    """The JAX engine's and the port's greedy streams on ``queue``, the
    prompts drawn from ``seed``."""
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n, _ in queue]
    out = []
    for eng in (JD.DecodeEngine(jp, jcfg, RULES, slots=slots,
                                capacity=capacity, segment_len=segment_len),
                D.DecodeEngine(tp, cfg, slots=slots, capacity=capacity,
                               segment_len=segment_len, device="cpu")):
        rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, queue)]
        res = eng.run()
        out.append([res[r] for r in rids])
    return out


def test_xlstm_engine_streams_equal_jax():
    """4 slots, nine requests: slots are recycled, so a fresh admission's
    states replace a finished request's."""
    arch = "xlstm-1.3b"
    ref, got = _engines(jax_config(arch), REG.get_config(arch, smoke=True),
                        4, QUEUE)
    assert [len(t) for t in got] == [m for _, m in QUEUE]
    assert got == ref


def test_moe_engine_streams_equal_jax(monkeypatch):
    """6 slots, nine requests of different ``max_new``.  In decode every
    slot is one token of the step's MoE batch: T = 6, so each expert
    keeps 4 entries.  Empty and finished slots repeat one token each and
    route alike, so some steps drop tokens (counted below), and which
    ones depends on every slot's routing, the finished slots' included.
    A finished slot's attention must see the token it feeds, as the
    reference's does before it discards the step's cache: on these
    prompts (seed 5) an attention that skips the finished slots' k/v
    routes them otherwise and changes live tokens."""
    arch = "qwen3-moe-30b-a3b"
    cfg = REG.get_config(arch, smoke=True)
    drops = []
    dispatch = M._dispatch_compute_combine

    def counting(xf, gates, idx, *a):
        T = idx.shape[0]
        if T == 6:
            counts = torch.bincount(idx.reshape(-1),
                                    minlength=cfg.moe.n_experts)
            drops.append(int(torch.clamp(counts - M._capacity(T, cfg),
                                         min=0).sum()))
        return dispatch(xf, gates, idx, *a)

    monkeypatch.setattr(M, "_dispatch_compute_combine", counting)
    ref, got = _engines(jax_config(arch), cfg, 6, QUEUE, seed=5)
    assert [len(t) for t in got] == [m for _, m in QUEUE]
    assert got == ref
    assert sum(drops) > 0
