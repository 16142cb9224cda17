"""One CSE-FSL round on the recurrentgemma smoke config against
``make_fed_round`` of :mod:`repro.core.protocols` (N=3, h=2): client,
server and server optimizer state at the round tests' ``PARAM_TOL``
and the metrics, as ``tests/test_torch_fo_round.py`` holds gpt2-tiny
and the small CNN.  The FO client differentiates the RG-LRU scan (on
the card: K6 and its reverse mode as the backward)."""
import torch_round_parity as RP
from repro_torch.configs.recurrentgemma_9b import smoke_config as rg_smoke


def test_cse_fsl_round_recurrentgemma_matches_jax():
    RP.fo_round_pair(RP.rg_setup(), "cse_fsl",
                     RP.round_batch("lm", RP.FO_N, 2,
                                    vocab=rg_smoke().vocab),
                     dict(n_clients=RP.FO_N, h=2))
