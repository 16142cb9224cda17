"""qwen2-vl-2b (M-RoPE, the vision frontend stub) in the port against the
JAX package on its smoke config (f32): the config values; the whole
model's forward on float patch embeddings with (3, B, S) grid ids; a
HERON round on the threefry stream with those ids; a kernel-stream round
without ids against the reference's Pallas kernels in interpret mode; a
datacenter HERON step with the ids; and the kernel stream's dual losses
with the ids against the reference's plain client loss on the clean
params and on ``ops.perturb_tree``'s theta + mu*U.

The last is the check the reference cannot run on its own kernel path:
its dual probe doubles the batch by concatenating positions on axis 0,
which for (3, B, S) ids is the t / h / w axis, and ``apply_mrope`` then
fails to broadcast (ROADMAP queue 3).  The port doubles them on the
batch axis."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_modality_parity as MP
import torch_round_parity as RP
from test_torch_family_rounds import config_values_match
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT

jax.config.update("jax_platform_name", "cpu")


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", [MP.VLM, MP.ENC_DEC])
def test_config_values_match_reference(name, smoke):
    config_values_match(name, smoke)


def test_full_forward_matches_jax():
    jcfg, cfg, params = MP.setup(MP.VLM)
    b = MP.batch(cfg)
    ref = jax.jit(lambda p, x, pos: JT.full_forward(p, jcfg, RP.RULES, x,
                                                    pos))(
        params, b["inputs"], b["positions"])
    got = T.full_forward(from_jax(params, device="cpu"), cfg,
                         torch.as_tensor(b["inputs"]),
                         torch.as_tensor(b["positions"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MP.TOL)
    np.testing.assert_allclose(
        float(T.lm_loss(got, torch.as_tensor(b["labels"]), cfg.vocab)),
        float(JT.lm_loss(ref, b["labels"], jcfg.vocab)), rtol=1e-6)


def test_heron_round_threefry_with_ids_matches_jax():
    MP.heron_rounds_match(MP.VLM, "threefry", ids=True)


def test_heron_round_kernel_without_ids_matches_jax_interpret():
    MP.heron_rounds_match(MP.VLM, "kernel", ids=False)


def test_kernel_dual_losses_with_ids_match_plain_jax():
    """``client_dual_loss`` on the kernel stream with (3, B, S) grid ids:
    l_clean is the reference's plain ``client_loss`` on theta, l_pert on
    ``perturb_tree(theta, seeds, mu)`` (the tied table's noise acts only
    through the aux head: the inputs are float), and the smashed data
    the clean forward's."""
    jcfg, cfg, params = MP.setup(MP.VLM)
    japi = JP.lm_api(jcfg, RP.RULES)
    api = P.lm_api(cfg.replace(forward_impl="kernel"))
    b = MP.batch(cfg)
    cp = params["client"]
    l0, lp, s = api.client_dual_loss(from_jax(cp, device="cpu"), _torch(b),
                                     O.leaf_seed_tree(cp, -2024), MP.MU)
    closs = jax.jit(japi.client_loss)
    r0, sr = closs(cp, b)
    rp, _ = closs(JO.perturb_tree(cp, JO.leaf_seed_tree(cp, jnp.int32(-2024)),
                                  MP.MU), b)
    np.testing.assert_allclose(float(l0), float(r0), rtol=1e-6)
    np.testing.assert_allclose(float(lp), float(rp), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **MP.TOL)
    assert float(l0) != float(lp)


def test_heron_train_step_with_ids_matches_jax():
    """Two datacenter HERON steps on the threefry stream (gaussian) with
    grid ids, as the reference's driver builds vision batches."""
    jcfg, cfg, params = MP.setup(MP.VLM)
    setup = (JP.lm_api(jcfg, RP.RULES), P.lm_api(cfg), params)
    batches = [MP.batch(cfg, seed=s) for s in (4, 5)]
    mu, lr = RP.THREEFRY_RATES["gaussian"]
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, "heron", (JZ.ZOConfig(mu=mu, scale="gaussian"),
                         Z.ZOConfig(mu=mu, scale="gaussian")),
        (JOPT.zo_sgd(lr), OPT.zo_sgd(lr)),
        (JOPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS),
         OPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS)), batches)
    RP.assert_train_state_close(st, jst, params)
    for k in ("loss", "client_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=RP.PARAM_TOL["rtol"])


def test_dual_positions_double_the_batch_axis():
    pos2 = torch.arange(6).reshape(2, 3)
    pos3 = torch.as_tensor(MP.grid_ids(2, 3))
    assert T.dual_positions(None) is None
    assert torch.equal(T.dual_positions(pos2), torch.cat([pos2, pos2]))
    got = T.dual_positions(pos3)
    assert got.shape == (3, 4, 3)
    assert torch.equal(got[:, :2], pos3) and torch.equal(got[:, 2:], pos3)
