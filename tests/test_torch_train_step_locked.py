"""The port's datacenter step against :mod:`repro.core.protocols`, as
``test_torch_train_step.py``: the training-lock methods (SFLV1, SFLV2,
and SplitLoRA training only its adapters through ``tc_pred``) on
gpt2-tiny, and HERON on the kernel stream on the small CNN split and on
the recurrentgemma smoke config (RG-LRU blocks through the whole-block
fallback).  Two steps from the same params, batches and ``PRNGKey(1)``;
params and both optimizer states at ``PARAM_TOL`` (rtol 2e-5, atol
1e-6), losses at rtol 2e-5."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.configs.gpt2 import gpt2_tiny as jax_gpt2_tiny
from repro.configs.recurrentgemma_9b import smoke_config as jax_rg_smoke
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.models import cnn as JCNN
from repro.models import lora as JLORA
from repro.optim import optimizers as JOPT
from repro_torch.configs.recurrentgemma_9b import smoke_config as rg_smoke
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.models import cnn as CNN
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path


def _adamw_pair(lr):
    return (JOPT.adamw(lr, eps=RP.FO_EPS), OPT.adamw(lr, eps=RP.FO_EPS))


def _check_losses(m, jm):
    for k in ("loss", "client_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=RP.PARAM_TOL["rtol"])


def _lora(path):
    return "lora" in path


def _leaf_at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.mark.parametrize("method", P.LOCKED_METHODS)
def test_locked_train_step_matches_jax(method):
    setup = RP.lm_setup()
    params, tc_pred = setup[2], None
    if method == "splitlora":
        client = JLORA.add_lora(jax.random.PRNGKey(5), params["client"],
                                rank=4)
        params = {**params, "client": jax.tree.map(np.asarray, client)}
        tc_pred = _lora
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, method, (JZ.ZOConfig(), Z.ZOConfig()),
        _adamw_pair(RP.FO_LR), _adamw_pair(RP.FO_SERVER_LR),
        RP.step_batches("lm", vocab=jax_gpt2_tiny().vocab), params=params,
        tc_pred=tc_pred)
    RP.assert_train_state_close(st, jst, params)
    _check_losses(m, jm)
    if tc_pred is not None:
        # only the adapters train: the frozen client leaves pass through
        for path, leaf in tree_leaves_with_path(st["params"]["client"]):
            if not _lora(path):
                np.testing.assert_array_equal(
                    leaf.numpy(), _leaf_at(params["client"], path))


def _cnn_kernel_setup():
    jcfg = dataclasses.replace(JCNN.CNNConfig(**RP.CNN_KW),
                               forward_impl="kernel")
    p = JCNN.init_cnn(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(CNN.CNNConfig(**RP.CNN_KW),
                              forward_impl="kernel")
    return (JP.cnn_api(jcfg), P.cnn_api(cfg), jax.tree.map(np.asarray, p))


def _rg_kernel_setup():
    return RP.lm_setup(dataclasses.replace(jax_rg_smoke(),
                                           forward_impl="kernel"),
                       rg_smoke().replace(forward_impl="kernel"))


@pytest.mark.parametrize("kind", ["cnn", "recurrentgemma"])
def test_heron_kernel_train_step_matches_jax(kind):
    if kind == "cnn":
        setup = _cnn_kernel_setup()
        batches = RP.step_batches("cnn")
    else:
        setup = _rg_kernel_setup()
        batches = RP.step_batches("lm", vocab=jax_rg_smoke().vocab)
    assert setup[1].client_dual_loss is not None
    (jst, jm), (st, m) = RP.train_steps_pair(
        setup, "heron", (JZ.ZOConfig(mu=1e-2), Z.ZOConfig(mu=1e-2)),
        (JOPT.zo_sgd(1e-3), OPT.zo_sgd(1e-3)),
        _adamw_pair(RP.FO_SERVER_LR), batches)
    RP.assert_train_state_close(st, jst, setup[2])
    _check_losses(m, jm)
