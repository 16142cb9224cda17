"""The port's training-lock rounds (SFLV1, SFLV2, SplitLoRA) against
``make_fed_round`` of :mod:`repro.core.protocols`, on gpt2-tiny and the
small CNN (N=3), at h in {1, 2} and with JAX's mask all ones and [1, 0,
1]: client, server and server optimizer state at ``PARAM_TOL`` and the
metrics, as ``tests/test_torch_fo_round.py`` holds the aux-head
methods.  SplitLoRA's adapters (rank 4 on the default targets) come
from JAX's ``add_lora`` through the bridge."""
import jax
import numpy as np
import pytest

import torch_round_parity as RP
from repro.models import lora as JLORA
from repro_torch.core import protocols as P


@pytest.fixture(scope="module", params=["lm", "cnn"])
def model(request):
    setup = {"lm": RP.lm_setup, "cnn": RP.cnn_setup}[request.param]
    return request.param, setup()


def _with_lora(method, params):
    if method != "splitlora":
        return params
    client = JLORA.add_lora(jax.random.PRNGKey(5), params["client"], rank=4)
    return {**params, "client": jax.tree.map(np.asarray, client)}


@pytest.mark.parametrize("case", RP.FO_CASES, ids=RP.FO_CASE_IDS)
@pytest.mark.parametrize("method", P.LOCKED_METHODS)
def test_locked_round_matches_jax(model, method, case):
    kind, setup = model
    RP.fo_round_case(kind, setup, method, case,
                  params=_with_lora(method, setup[2]))
