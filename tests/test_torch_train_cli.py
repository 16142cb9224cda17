"""The port's training driver, ``repro_torch.launch.train.main``, run
in-process on the CPU with ``--smoke``: a resumed datacenter run ends
where an uninterrupted one does, bit for bit; ``--fed`` (lean uplink)
and ``--fed-async --cutplan`` print the losses and cut plans of
``repro.launch.train.main`` with the same arguments; ``--replay-shard
clients --replay-chunk 3`` on one rank ends where the flat replay does,
bit for bit; ``--model-parallel 2`` on one rank (the model axis falls
back to 1) ends where the run without it does, bit for bit (its two-rank
run is in ``test_torch_mesh_axes.py``); ``build_batch`` gives the
reference's enc-dec, vision and audio batches, and ``--fed`` refuses
those archs as the reference's does."""
import dataclasses
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs import registry as JREG
from repro.data import synthetic as JDATA
from repro.launch import train as JTRAIN
from repro_torch.configs import registry as REG
from repro_torch.core import prng as R
from repro_torch.data import synthetic as DATA
from repro_torch.launch import train as TRAIN

BASE = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--seq", "16"]
# the sphere at the threefry rounds' rates (torch_round_parity.
# THREEFRY_RATES): losses agree to a few f32 ulps, and the driver prints
# four decimals, so two print quanta
FED = BASE + ["--clients", "2", "--local-steps", "2", "--zo-mu", "0.1",
              "--lr-client", "1e-4", "--lr-server", "1e-4"]
LOSS_ATOL = 2e-4
ROUND = re.compile(r"\[fed\] round +(\d+) client_loss=([-\d.]+) "
                   r"server_loss=([-\d.]+)")
PLAN = re.compile(r"\[cutplan\] client (\d+): (\S+) +cut=(\d+) "
                  r"est_round=\S+ feasible=(\w+)")


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _payload(ckpt_dir, step):
    return np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                                "payload.npz"))


def test_resume_equals_uninterrupted(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = BASE + ["--device", "cpu", "--steps", "6", "--ckpt-dir", d,
                   "--ckpt-every", "2"]
    out = _run(TRAIN.main, argv, capsys)
    assert "restored" not in out and "[train] step    5" in out
    full = dict(_payload(d, 6))
    shutil.rmtree(os.path.join(d, "step_00000006"))
    out = _run(TRAIN.main, argv, capsys)
    assert "[train] restored checkpoint at step 4" in out
    resumed = _payload(d, 6)
    assert set(resumed) == set(full)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k])


def _rounds(out):
    return [tuple(map(float, m.groups()[1:])) for m in ROUND.finditer(out)]


@pytest.mark.parametrize("mode", ["fed", "fed-async"])
def test_fed_runs_print_the_reference_losses(mode, capsys):
    # one round each: the reference's launch.train compiles its round again
    # for a second one (~8 s on the CPU)
    if mode == "fed":
        argv = FED + ["--fed", "--uplink", "seed_replay", "--steps", "1"]
    else:
        argv = FED + ["--fed-async", "--staleness", "0.5", "--buffer-k",
                      "1", "--cutplan", "--steps", "1"]
    out = _run(TRAIN.main, argv + ["--device", "cpu"], capsys)
    ref = _run(JTRAIN.main, argv, capsys)
    got, want = _rounds(out), _rounds(ref)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    if mode == "fed-async":
        assert "flushes=2" in out and "flushes=2" in ref
        # the plans agree (the bytes are counted differently, so the
        # estimated round times do not)
        assert [m.groups() for m in PLAN.finditer(out)] == \
            [m.groups() for m in PLAN.finditer(ref)]
        assert len(PLAN.findall(out)) == 2


@pytest.mark.parametrize("flags", [["--model-parallel", "2"]],
                         ids=["model-parallel"])
def test_mesh_flags_raise(flags, tmp_path, capsys):
    """The flag that raised until the datacenter step's mesh mode was
    ported now runs: on one rank (the group the driver starts and
    destroys) ``make_local_mesh(2)`` falls back to the ("data" 1, "model"
    1) mesh, and the final checkpoint and printed lines are the run
    without the flag, bit for bit."""
    import torch.distributed as dist
    outs, ckpts = [], []
    for extra in ([], flags):
        d = str(tmp_path / f"ckpt{len(extra)}")
        out = _run(TRAIN.main, BASE + ["--device", "cpu", "--steps", "2",
                                       "--ckpt-dir", d] + extra, capsys)
        outs.append(re.sub(r"\(\d+\.\ds\)", "", out.replace(d, "D")))
        ckpts.append(dict(_payload(d, 2)))
        assert not dist.is_initialized()
    assert outs[0] == outs[1] and "[train] step    1" in outs[0]
    assert set(ckpts[0]) == set(ckpts[1])
    for k in ckpts[0]:
        np.testing.assert_array_equal(ckpts[1][k], ckpts[0][k])


@pytest.mark.parametrize("mode", ["fed", "fed-async"])
def test_replay_shard_and_chunk_equal_the_flat_round(mode, monkeypatch,
                                                     capsys):
    """``--replay-shard clients --replay-chunk 3`` on one rank (a gloo
    group the driver starts and destroys): the final client and server
    params equal those of the same command without the two flags, bit
    for bit, and so do the printed lines: one rank sums nothing across
    ranks, and the chunk changes nothing in the eager walk."""
    import torch.distributed as dist
    from repro_torch.core import protocols as P
    from repro_torch.tree import tree_leaves

    last = {}
    for name in ("make_fed_round", "make_async_round"):
        def wrap(*a, _make=getattr(P, name), **kw):
            rnd = _make(*a, **kw)

            def recorded(*ra, **rkw):
                last["state"], m = rnd(*ra, **rkw)
                return last["state"], m

            return recorded

        monkeypatch.setattr(P, name, wrap)
    argv = FED + ["--device", "cpu", "--steps", "2", "--uplink",
                  "seed_replay", f"--{mode}"]
    assert not dist.is_initialized()
    plain_out = _run(TRAIN.main, argv, capsys)
    plain = last.pop("state")
    out = _run(TRAIN.main, argv + ["--replay-shard", "clients",
                                   "--replay-chunk", "3"], capsys)
    assert not dist.is_initialized()
    assert _rounds(out) == _rounds(plain_out) and len(_rounds(out)) == 2
    for part in ("client", "server"):
        for a, b in zip(tree_leaves(last["state"][part]),
                        tree_leaves(plain[part])):
            assert torch.equal(a, b)


def test_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRAIN.main(BASE + ["--steps", "1"])


@pytest.mark.parametrize("arch,frontend", [
    ("seamless-m4t-medium", "audio"), ("qwen2-vl-2b", "vision"),
    ("qwen2-vl-2b", "audio")], ids=["enc-dec", "vision", "audio"])
def test_build_batch_matches_jax(arch, frontend):
    """The enc-dec, vision and audio batches of ``build_batch`` from the
    same bigram data and key: the token leaves equal, the frontend stub's
    embeddings (JAX's normals) within 4 f32 ulps, the M-RoPE ids equal.
    The audio case is qwen2-vl's smoke config with the audio frontend
    (the reference registers no decoder-only audio arch)."""
    jcfg = dataclasses.replace(JREG.get_config(arch, smoke=True),
                               frontend=frontend)
    cfg = REG.get_config(arch, smoke=True).replace(frontend=frontend)
    want = JTRAIN.build_batch(
        jcfg, JDATA.BigramLM(vocab=jcfg.vocab, seq_len=16, seed=0),
        jax.random.fold_in(jax.random.PRNGKey(7), 3), 2, 16)
    got = TRAIN.build_batch(cfg, DATA.BigramLM(vocab=cfg.vocab, seq_len=16,
                                               seed=0),
                            R.fold_in(R.PRNGKey(7), 3), 2, 16)
    assert set(got) == set(want)
    for k, b in want.items():
        a, b = got[k].numpy(), np.asarray(b)
        assert a.shape == b.shape, k
        if k == "inputs":
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=4 * np.spacing(
                np.float32(np.abs(b).max())))
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_fed_refuses_modality_archs(arch):
    with pytest.raises(SystemExit, match="decoder-only text archs"):
        TRAIN.main(["--arch", arch, "--smoke", "--device", "cpu", "--fed",
                    "--steps", "1"])
