"""The port's checkpoint (:mod:`repro_torch.checkpoint.checkpoint`) and
fault drills (:mod:`repro_torch.distributed.fault`): the reference's
``tests/test_checkpoint.py`` and ``run_resilient`` cases on the port,
checkpoints written by either package restored by the other bit for bit
(bf16 leaves, int32 step counts and the uint32 key included), and a
resilient run of the port's train step with injected faults equal to an
uninterrupted one bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.checkpoint import checkpoint as JC
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.core import protocols as JP
from repro.distributed import fault as JF
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs.gpt2 import gpt2_tiny
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.distributed import fault as F
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "e": (torch.zeros(2), torch.full((1,), 7.5))}


def _leaves(t):
    """Leaves in JAX's order, as they are (tensors and ints)."""
    return [leaf for _, leaf in tree_leaves_with_path(t, sort_keys=True)]


def test_roundtrip(tmp_path):
    t = tree()
    C.save(str(tmp_path), 5, t)
    restored, step = C.restore(str(tmp_path), t)
    assert step == 5
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    t = tree()
    for s in range(6):
        C.save(str(tmp_path), s, t, keep=3)
    assert C.all_steps(str(tmp_path)) == [3, 4, 5]
    assert C.latest_step(str(tmp_path)) == 5


def test_restore_specific_step(tmp_path):
    t = tree()
    C.save(str(tmp_path), 1, t, keep=5)
    t2 = {**t, "a": t["a"] + 1}
    C.save(str(tmp_path), 2, t2, keep=5)
    r1, _ = C.restore(str(tmp_path), t, step=1)
    assert torch.equal(r1["a"], t["a"])


def test_structure_mismatch_raises(tmp_path):
    C.save(str(tmp_path), 0, tree())
    with pytest.raises(AssertionError):
        C.restore(str(tmp_path), {"only": torch.zeros(1)})


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path / "nope"), tree())


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_states():
    """The same bf16 gpt2-tiny train state in each package (AdamW on both
    sides: f32 moments, int32 / int step counts, the uint32 key)."""
    jcfg = dataclasses.replace(jax_gpt2_tiny(), **RP.BF16)
    params = jax.tree.map(np.asarray,
                          JT.init_lm(jax.random.PRNGKey(0), jcfg))
    jopt, opt = JOPT.adamw(1e-3), OPT.adamw(1e-3)
    jst = JP.init_train_state(jax.random.PRNGKey(1), params, jopt, jopt)
    jst = {**jst, "step": jnp.asarray(7, jnp.int32)}
    st = P.init_train_state(R.PRNGKey(1), from_jax(params, "cpu"), opt, opt)
    return jst, {**st, "step": 7}


def test_port_restores_a_jax_checkpoint(tmp_path, train_states):
    jst, st = train_states
    JC.save(str(tmp_path), 7, jst)
    got, step = C.restore(str(tmp_path), st)
    assert step == 7 and got["step"] == 7
    mine, want = _leaves(got), jax.tree.leaves(jst)
    assert [str(t.dtype) for t in _leaves(st) if torch.is_tensor(t)] == [
        str(t.dtype) for t in mine if torch.is_tensor(t)]
    assert got["rng"].dtype == torch.uint32
    assert len(mine) == len(want)
    for a, b in zip(mine, want):
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


def test_jax_restores_a_port_checkpoint(tmp_path, train_states):
    jst, st = train_states
    C.save(str(tmp_path), 7, st)
    got, step = JC.restore(str(tmp_path), jst)
    assert step == 7 and int(got["step"]) == 7
    assert got["rng"].dtype == jnp.uint32
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


# ---------------------------------------------------------------------------
# run_resilient
# ---------------------------------------------------------------------------

def _toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w, "step": state["step"] + 1}, {"loss": torch.sum(w)}


def _toy_jax_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w, "step": state["step"] + 1}, {"loss": jnp.sum(w)}


def _tel(t):
    return dataclasses.astuple(t)


def test_run_resilient_recovers_from_injected_faults(tmp_path):
    """The reference's case on the port: injected faults restart from
    the last checkpoint and end at the fault-free state; the telemetry
    equals JAX's on the same drill."""
    def batch_fn(step):
        return torch.full((4,), float(step % 3))

    state0 = {"w": torch.ones(4) * 10.0, "step": 0}
    clean, _, r0 = F.run_resilient(_toy_step, state0, batch_fn, 20,
                                   str(tmp_path / "clean"), ckpt_every=4,
                                   sleep=lambda s: None)
    assert r0.restarts == 0 and r0.backoff_total_s == 0.0
    faulty, _, r1 = F.run_resilient(
        _toy_step, state0, batch_fn, 20, str(tmp_path / "faulty"),
        ckpt_every=4, injector=F.FaultInjector(fail_at=(7, 13)),
        sleep=lambda s: None)
    assert r1.restarts == 2
    assert r1.from_checkpoint == 2 and r1.from_start == 0
    assert r1.resumed_at == [4, 12]
    assert r1.backoff_total_s == F.backoff_s(1) + F.backoff_s(2)
    assert torch.equal(clean["w"], faulty["w"]) and faulty["step"] == 20
    _, _, jr1 = JF.run_resilient(
        _toy_jax_step, {"w": jnp.ones(4) * 10.0,
                        "step": jnp.zeros((), jnp.int32)},
        lambda s: jnp.full((4,), float(s % 3)), 20, str(tmp_path / "jax"),
        ckpt_every=4, injector=JF.FaultInjector(fail_at=(7, 13)),
        sleep=lambda s: None)
    assert _tel(r1) == _tel(jr1)


def test_run_resilient_replays_from_start_without_checkpoint(tmp_path):
    seen = []

    def step_fn(state, batch):
        seen.append(state["step"])
        return {"w": state["w"] - 0.1 * batch,
                "step": state["step"] + 1}, {}

    def batch_fn(step):
        return torch.full((2,), float(step))

    state0 = {"w": torch.zeros(2), "step": 0}
    out, _, tel = F.run_resilient(step_fn, state0, batch_fn, 4,
                                  str(tmp_path), ckpt_every=100,
                                  injector=F.FaultInjector(fail_at=(2,)),
                                  sleep=lambda s: None)
    assert tel.restarts == 1
    assert tel.from_start == 1 and tel.from_checkpoint == 0
    assert tel.resumed_at == [0]
    assert seen == [0, 1, 0, 1, 2, 3]
    clean, _, _ = F.run_resilient(step_fn, state0, batch_fn, 4,
                                  str(tmp_path / "clean"), ckpt_every=100,
                                  sleep=lambda s: None)
    assert torch.equal(out["w"], clean["w"])


@pytest.mark.parametrize("attempt", [1, 2, 3, 10])
def test_backoff_bounded_exponential(attempt):
    assert F.backoff_s(attempt, base=0.05, cap=1.0) == JF.backoff_s(
        attempt, base=0.05, cap=1.0)
    assert F.backoff_s(10) == 1.0


def test_run_resilient_gives_up_after_max_retries(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError):
        F.run_resilient(step_fn, {"w": torch.ones(2)}, lambda s: None, 5,
                        str(tmp_path), max_retries=2, sleep=lambda s: None)


def test_remesh_counts_visible_devices():
    """``remesh`` is ``make_local_mesh``, as in the reference: the mesh of
    the ranks now running (one without a group), a model axis that does
    not divide them falling back to 1 (four ranks:
    ``test_torch_train_mesh.py``)."""
    for mp in (1, 2):
        assert F.remesh(mp).shape == {"data": 1, "model": 1}


def test_resilient_train_step_equals_uninterrupted(tmp_path):
    """HERON's datacenter step on gpt2-tiny (kernel stream, plain
    versions): five steps with faults at steps 1 and 3, a checkpoint
    every 2, end where five clean steps end, bit for bit."""
    jparams = jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(0),
                                                  jax_gpt2_tiny()))
    cfg = gpt2_tiny().replace(forward_impl="kernel")
    api = P.lm_api(cfg)
    copt, sopt = OPT.zo_sgd(1e-3), OPT.adamw(1e-4)
    step_fn = P.make_train_step(api, "heron", Z.ZOConfig(mu=1e-2), copt,
                                sopt)
    batches = RP.step_batches("lm", vocab=cfg.vocab, n=5)

    def batch_fn(step):
        return {k: torch.as_tensor(v) for k, v in batches[step].items()}

    def run(name, injector):
        st = P.init_train_state(R.PRNGKey(1), from_jax(jparams, "cpu"),
                                copt, sopt)
        return F.run_resilient(step_fn, st, batch_fn, 5,
                               str(tmp_path / name), ckpt_every=2,
                               injector=injector, sleep=lambda s: None)

    clean, _, _ = run("clean", None)
    faulty, _, tel = run("faulty", F.FaultInjector(fail_at=(1, 3)))
    assert tel.restarts == 2 and tel.resumed_at == [0, 2]
    assert tel.from_start == 1 and tel.from_checkpoint == 1
    assert faulty["step"] == clean["step"] == 5
    for a, b in zip(RP.leaves(clean), RP.leaves(faulty)):
        np.testing.assert_array_equal(a, b)
