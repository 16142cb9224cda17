"""The port's buffered-async round, fleet controller and their contracts,
as ``tests/test_async_round.py`` holds the reference's:

* w(tau=0) is exactly 1.0, so one full-cohort flush of
  ``AsyncReplayServer`` equals the port's ``seed_replay_aggregate`` bit
  for bit on both streams, and ``make_async_round`` at ``buffer_k=0``
  equals the port's ``make_fed_round(uplink="seed_replay")`` bit for bit
  (client and server params), and JAX's at ``PARAM_TOL``;
* buffered flushes give JAX's telemetry (flushes, staleness, flush
  times);
* masked clients contribute nothing in any arrival order;
* the controller's retries, backoff, drops, discards and telemetry equal
  JAX's controller on the same drill.

The CNN rounds run the small CNN split on ``GaussianMixtureImages``
batches drawn by the port (the same numpy arrays go to JAX)."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

import torch_round_parity as RP
from torch_round_parity import one_torch_thread  # noqa: F401
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.distributed.fault import FaultInjector as JFaultInjector
from repro.fed import AsyncReplayServer as JServer
from repro.fed import FleetController as JController
from repro.fed import StalenessConfig as JStaleness
from repro.fed import staleness_weight as j_staleness_weight
from repro.fed.cutplan import CutPlan as JCutPlan
from repro.fed.cutplan import DeviceProfile as JDeviceProfile
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.data.pipeline import round_batches
from repro_torch.data.synthetic import GaussianMixtureImages
from repro_torch.distributed.fault import FaultInjector
from repro_torch.fed import (AsyncReplayServer, FleetController,
                             StalenessConfig, staleness_weight)
from repro_torch.fed.cutplan import CutPlan, DeviceProfile
from repro_torch.kernels import ops as O
from repro_torch.optim import optimizers as OPT


def make_params():
    return {"w": torch.ones((6, 3)), "b": {"c": torch.linspace(-1.0, 1.0,
                                                                5)}}


def assert_trees_equal(a, b):
    la, lb = RP.leaves(a), RP.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 3.0])
def test_staleness_weight_equals_jax(alpha):
    for tau in range(6):
        assert staleness_weight(tau, alpha) == j_staleness_weight(tau,
                                                                  alpha)
    assert staleness_weight(0, alpha) == 1.0
    assert StalenessConfig(alpha=2.0).weight(1) == 0.25


def test_single_flush_bit_exact_threefry():
    params = make_params()
    n, h, pairs, lr = 4, 2, 2, 1e-2
    zo = Z.ZOConfig(mu=1e-3, n_pairs=pairs)
    keys = Z.fold_in_range(R.PRNGKey(42), n)
    coeffs = R.normal(R.PRNGKey(1), (n, h, pairs))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    ref = AG.seed_replay_aggregate(params, keys, coeffs, lr, zo, mask)
    srv = AsyncReplayServer(params, lr, zo)
    for cid in (2, 0, 3, 1):                      # scrambled arrivals
        srv.submit(cid, keys[cid], coeffs[cid], mask=float(mask[cid]))
    assert srv.version == 0                       # buffer_k=0: no auto
    srv.flush()
    assert srv.version == 1
    assert_trees_equal(ref, srv.params)
    assert srv.telemetry.dropped == 1


def test_single_flush_bit_exact_kernel():
    params = make_params()
    n, h, pairs, lr = 3, 1, 2, 1e-2
    seeds = O.fold_seed(9, np.arange(n))
    coeffs = R.normal(R.PRNGKey(5), (n, h, pairs))
    ref = AG.seed_replay_aggregate_kernel(params, seeds, coeffs, lr)
    srv = AsyncReplayServer(params, lr, kernel=True)
    for cid in (1, 2, 0):
        srv.submit(cid, seeds[cid], coeffs[cid])
    srv.flush()
    assert_trees_equal(ref, srv.params)


# ---------------------------------------------------------------------------
# the async round on the small CNN
# ---------------------------------------------------------------------------

N, H = 4, 2


@pytest.fixture(scope="module")
def cnn():
    """(JAX api, port api, numpy params, numpy round batch)."""
    japi, api, params = RP.cnn_setup()
    ds = GaussianMixtureImages(classes=RP.CNN_KW["classes"], hw=8,
                               noise=0.5)
    rb = round_batches(ds, R.PRNGKey(3), N, H, 8)
    return japi, api, params, {k: v.numpy() for k, v in rb.items()}


def _port_state(params, sopt):
    tp = from_jax(params, device="cpu")
    return {"client": tp["client"], "server": tp["server"],
            "opt_server": sopt.init(tp["server"])}


def _jax_state(params, sopt):
    return {"client": params["client"], "server": params["server"],
            "opt_server": sopt.init(params["server"])}


def _torch(rb):
    return {k: torch.as_tensor(v) for k, v in rb.items()}


@pytest.mark.parametrize("kernel", [False, True], ids=["threefry",
                                                       "kernel"])
def test_async_round_bit_exact_vs_sync_at_buffer0(cnn, kernel):
    """make_async_round(buffer_k=0, alpha=0) == make_fed_round(uplink=
    'seed_replay'), client and server params byte for byte, stragglers
    masked in both, arrivals in a scrambled order."""
    _, api, params, rb = cnn
    if kernel:
        from repro_torch.models import cnn as CNN
        api = P.cnn_api(dataclasses.replace(CNN.CNNConfig(**RP.CNN_KW),
                                            forward_impl="kernel"))
    lr = 2e-2
    zo = Z.ZOConfig(mu=1e-3, n_pairs=2)
    fed = P.FedConfig(n_clients=N, h=H, straggler_prob=0.4)
    copt, sopt = OPT.zo_sgd(lr), OPT.adamw(2e-3)
    # PRNGKey(3) masks clients 1 and 3 at straggler_prob 0.4
    state, key = _port_state(params, sopt), R.PRNGKey(3)
    s_sync, m_sync = P.make_fed_round(api, "heron", zo, fed, copt, sopt,
                                      uplink="seed_replay",
                                      client_lr=lr)(state, _torch(rb), key)
    s_async, m_async = P.make_async_round(
        api, "heron", zo, fed, copt, sopt, client_lr=lr)(
            state, _torch(rb), key, durations=[3.0, 1.0, 4.0, 2.0])
    assert float(m_sync["participants"]) < N      # a straggler was masked
    for part in ("client", "server", "opt_server"):
        assert_trees_equal(s_sync[part], s_async[part])
    for k in ("client_loss", "server_loss", "participants", "uplink_bytes",
              "uplink_bytes_dense"):
        assert float(m_sync[k]) == float(m_async[k]), k
    assert m_async["flushes"] == 1.0
    assert m_async["mean_staleness"] == 0.0
    assert m_async["sim_makespan_s"] == 4.0


TELEMETRY = ("flushes", "mean_staleness", "sim_makespan_s",
             "time_to_first_update_s", "updates_per_sim_s")


@pytest.mark.parametrize("buffer_k,alpha,durations", [
    (0, 0.0, [3.0, 1.0, 4.0, 2.0]), (2, 0.5, [1.0, 1.0, 10.0, 1.0])],
    ids=["buffer0", "buffer2"])
def test_async_round_matches_jax(cnn, buffer_k, alpha, durations):
    """The port's async round against JAX's on the same batches and key:
    the telemetry equal, the states at PARAM_TOL (threefry sphere at the
    threefry rounds' rates, torch_round_parity.THREEFRY_RATES)."""
    japi, api, params, rb = cnn
    mu, lr = RP.THREEFRY_RATES["sphere"]
    jkw = dict(client_lr=lr, staleness_alpha=alpha, buffer_k=buffer_k)
    jsopt, sopt = JOPT.adamw(RP.THREEFRY_SERVER_LR), \
        OPT.adamw(RP.THREEFRY_SERVER_LR)
    jnew, jm = JP.make_async_round(
        japi, "heron", JZ.ZOConfig(mu=mu), JP.FedConfig(n_clients=N, h=H),
        JOPT.zo_sgd(lr), jsopt, **jkw)(
            _jax_state(params, jsopt), rb, jax.random.PRNGKey(9),
            durations=durations)
    new, m = P.make_async_round(
        api, "heron", Z.ZOConfig(mu=mu), P.FedConfig(n_clients=N, h=H),
        OPT.zo_sgd(lr), sopt, **jkw)(
            _port_state(params, sopt), _torch(rb), R.PRNGKey(9),
            durations=durations)
    for k in TELEMETRY:
        assert float(m[k]) == float(jm[k]), k
    if buffer_k:
        assert m["flushes"] == 2.0 and m["mean_staleness"] > 0.0
        assert m["time_to_first_update_s"] == 1.0
    RP.assert_state_close(new, jax.tree.map(np.asarray, jnew), params)
    RP.assert_metrics_close(m, jm)


def test_masked_clients_contribute_nothing_any_order():
    """All 2^n mask patterns x arrival orders x buffer sizes: poisoning a
    masked client's coefficients is a byte-exact no-op, and at
    buffer_k=0 the arrival order is irrelevant."""
    params = make_params()
    n, h, pairs, lr = 4, 1, 2, 1e-2
    zo = Z.ZOConfig(mu=1e-3, n_pairs=pairs)
    keys = Z.fold_in_range(R.PRNGKey(0), n)
    coeffs = R.normal(R.PRNGKey(1), (n, h, pairs))
    orders = [(0, 1, 2, 3), (3, 2, 1, 0), (2, 0, 3, 1)]

    def run(order, mask, cfs, buffer_k):
        srv = AsyncReplayServer(params, lr, zo,
                                staleness=StalenessConfig(alpha=0.7),
                                buffer_k=buffer_k)
        for cid in order:
            srv.submit(cid, keys[cid], cfs[cid], mask=mask[cid])
        srv.flush()
        return srv.params

    for mask in itertools.product([0.0, 1.0], repeat=n):
        poisoned = coeffs.clone()
        for cid in range(n):
            if mask[cid] == 0.0:
                poisoned[cid] = 1e6
        for buffer_k in (0, 3):
            for order in orders:
                out = run(order, mask, coeffs, buffer_k)
                assert_trees_equal(out, run(order, mask, poisoned,
                                            buffer_k))
                if buffer_k == 0:
                    assert_trees_equal(out, run(range(n), mask, coeffs, 0))


# ---------------------------------------------------------------------------
# the fleet controller, against JAX's on the same drill
# ---------------------------------------------------------------------------

def _fleets(injector=None, buffer_k=0, alpha=0.0, fail_always=False):
    """The reference test's tiny fleet in each package: ``(port server,
    port controller), (JAX server, JAX controller)``."""
    h, pairs, lr = 1, 2, 1e-2

    def port_fn(global_params, cid, round_idx, base_version):
        ck = R.fold_in(R.fold_in(R.PRNGKey(7), round_idx), cid)
        return ck, R.normal(ck, (h, pairs)), 1.0

    def jax_fn(global_params, cid, round_idx, base_version):
        ck = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(7), round_idx), cid)
        return np.asarray(ck), jax.random.normal(ck, (h, pairs)), 1.0

    class AlwaysFail:
        def check(self, step):
            raise RuntimeError("dead device")

    out = []
    for srv_cls, ctl_cls, zo, fn, params, inj in (
            (AsyncReplayServer, FleetController,
             Z.ZOConfig(mu=1e-3, n_pairs=pairs), port_fn, make_params(),
             FaultInjector), (JServer, JController,
                              JZ.ZOConfig(mu=1e-3, n_pairs=pairs), jax_fn,
                              jax.tree.map(lambda t: t.numpy(),
                                           make_params()), JFaultInjector)):
        stal = (StalenessConfig if srv_cls is AsyncReplayServer
                else JStaleness)(alpha=alpha)
        srv = srv_cls(params, lr, zo, buffer_k=buffer_k, staleness=stal)
        injector_ = (AlwaysFail() if fail_always else
                     None if injector is None else inj(fail_at=injector))
        out.append((srv, ctl_cls(srv, fn, injector=injector_,
                                 sleep=lambda s: None, max_retries=2)))
    return out


def _plans(port, durations):
    prof = (DeviceProfile if port else JDeviceProfile)("d", 1e9, 1e9, 1e9)
    plan = CutPlan if port else JCutPlan
    return [(prof, plan(cut=1, round_s=d, feasible=True))
            for d in durations]


def _same_telemetry(fleets):
    (srv, ctl), (jsrv, jctl) = fleets
    assert dataclasses.astuple(ctl.telemetry) == dataclasses.astuple(
        jctl.telemetry)
    assert dataclasses.astuple(srv.telemetry) == dataclasses.astuple(
        jsrv.telemetry)
    assert srv.version == jsrv.version
    for a, b in zip(RP.leaves(srv.params), jax.tree.leaves(jsrv.params)):
        np.testing.assert_allclose(a, np.asarray(b), **RP.PARAM_TOL)


def test_controller_fault_drill_retries_with_backoff():
    fleets = _fleets(injector=(1,))
    for port, (srv, ctl) in zip((True, False), fleets):
        for prof, plan in _plans(port, (1.0, 2.0)):
            ctl.admit(prof, plan)
        assert ctl.run(4) == 4
        t = ctl.telemetry
        assert t.restarts == 1 and t.backoff_total_s > 0.0
        assert t.completed == 4 and t.dropped == 0
        assert srv.telemetry.arrivals == 4
    _same_telemetry(fleets)


def test_controller_gives_up_and_drops_permanent_faulter():
    fleets = _fleets(fail_always=True)
    for port, (srv, ctl) in zip((True, False), fleets):
        ctl.admit(*_plans(port, (1.0,))[0])
        assert ctl.run(1) == 0
        assert ctl.telemetry.restarts == ctl.max_retries + 1
        assert ctl.telemetry.dropped == 1
        assert srv.telemetry.arrivals == 0
    _same_telemetry(fleets)


def test_controller_discards_dropped_clients_inflight_result():
    fleets = _fleets()
    for port, (srv, ctl) in zip((True, False), fleets):
        (pf, fast_plan), (ps, slow_plan) = _plans(port, (1.0, 50.0))
        fast, slow = ctl.admit(pf, fast_plan), ctl.admit(ps, slow_plan)
        ctl.run(2, redispatch=False)
        before = srv.telemetry.arrivals
        ctl._dispatch(ctl.clients[slow], ctl.now)
        ctl.drop(slow)
        ctl.run(1, redispatch=False)
        assert ctl.telemetry.discarded == 1
        assert srv.telemetry.arrivals == before
        assert ctl.clients[fast].active and not ctl.clients[slow].active
    _same_telemetry(fleets)


def test_controller_staleness_across_versions():
    fleets = _fleets(buffer_k=2, alpha=0.5)
    for port, (srv, ctl) in zip((True, False), fleets):
        for prof, plan in _plans(port, (1.0, 1.0, 30.0)):
            ctl.admit(prof, plan)
        ctl.run(5)
        assert srv.version >= 2
        ctl.run(1)
        srv.flush()
        assert srv.telemetry.staleness_sum > 0.0
        assert ctl.telemetry.remeshes == 3
    _same_telemetry(fleets)


def test_async_validation():
    with pytest.raises(ValueError, match="ZOConfig"):
        AsyncReplayServer(make_params(), 1e-2)
    # the replay's modes and the datacenter step's placements are taken
    # (tests/test_torch_replay_mesh.py runs the modes,
    # test_torch_mesh_axes.py the placements)
    AsyncReplayServer(make_params(), 1e-2, Z.ZOConfig(), chunk=4,
                      shard="clients")
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.mesh import Mesh
    rules = S.AxisRules(mesh=Mesh({"data": 1, "model": 2},
                                  coords={"model": 1}))
    AsyncReplayServer(make_params(), 1e-2, Z.ZOConfig(),
                      shardings=S.tree_shardings(rules, {
                          "w": S.Logical(("d_model", "d_ff")),
                          "b": {"c": S.Logical(("d_ff",))}}, make_params()))
    sopt = OPT.adamw(1e-3)
    fed = P.FedConfig(n_clients=2, h=1)
    with pytest.raises(ValueError, match="heron"):
        P.make_async_round(None, "cse_fsl", Z.ZOConfig(), fed,
                           OPT.adamw(1e-3), sopt, client_lr=1e-2)
    with pytest.raises(ValueError, match="client_lr"):
        P.make_async_round(None, "heron", Z.ZOConfig(), fed,
                           OPT.zo_sgd(1e-2), sopt, client_lr=None)
    from repro_torch.models import cnn as CNN
    assert callable(P.make_async_round(
        P.cnn_api(CNN.CNNConfig(**RP.CNN_KW)), "heron", Z.ZOConfig(), fed,
        OPT.zo_sgd(1e-2), sopt, client_lr=1e-2, replay_shard="clients",
        replay_chunk=4))
