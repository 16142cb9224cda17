"""The HERON round on the threefry stream on the small CNN against
:mod:`repro.core.protocols` (the gpt2-tiny cases, the mask and the
``forward_impl`` checks are in ``tests/test_torch_round_threefry.py``):
h 1 and 2, both scales, both uplinks, the straggler mask drawn by the
port from the round key."""
import jax
import pytest

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

KEY = jax.random.PRNGKey(13)
CASES = [(1, "sphere", "seed_replay", 1.0, 0.0),
         (2, "gaussian", "dense", 2 / 3, 0.3)]


@pytest.mark.parametrize("case", CASES, ids=RP.threefry_case_ids(CASES))
def test_threefry_cnn_round_matches_jax(case):
    RP.threefry_round_case("cnn", case, KEY)
