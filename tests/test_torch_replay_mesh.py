"""The seed replay's three modes (``repro_torch.core.aggregate.
_replay_engine``) against the flat walk and the JAX package's flat
replay:

* in process: unsharded ``chunk`` in (1, 3, 7, 20, 64) is the flat walk
  bit for bit on both streams; the flat walk matches JAX's flat replay;
  a one-rank gloo group's ``shard="clients"`` is the flat walk bit for
  bit, with ``chunk`` too; an axis the mesh lacks raises "not in mesh",
  and ``mesh=None`` with no process group running raises;
* across ranks: one ``torch.multiprocessing`` spawn per world size (2
  and 4; gloo on a ``FileStore``), each running every case of the
  reference's ``_SHARDED_PROG`` (``tests/test_seed_replay.py``) in its
  ranks (``torch_mesh_ranks.py``): n = 7 clients, not divisible by the
  world, h = 2, n_pairs = 2, masked and unmasked, threefry and kernel
  streams, ``shard`` and ``shard + chunk=3`` each against JAX's flat
  replay at rtol 1e-5, atol 1e-6 (the reference's bar), poisoned masked
  coefficients changing nothing, ``shard + chunk`` the sharded walk bit
  for bit, and every rank's result rank 0's bit for bit.  The world-2
  spawn also runs a sharded seed-replay round on the small CNN against
  the port's unsharded round (the server's state bit for bit, the
  client within the sharded bar; ``tests/test_torch_round_threefry_cnn.
  py`` holds the unsharded seed-replay round to JAX's), and the async
  round sharded (allclose) and chunked (bit for bit) against the
  unsharded one at ``buffer_k=0``.

The JAX side runs here; the ranks read the inputs from an ``.npz`` and
import only ``repro_torch``.  A spawn that outlives ``SPAWN_TIMEOUT_S``
is killed and fails its test."""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_mesh_ranks as RANKS
import torch_round_parity as RP
from repro.core import aggregate as JAG
from repro.core import zo as JZ
from repro.kernels import ops as JO
from repro_torch.core import aggregate as AG
from repro_torch.core import prng as R
from repro_torch.core import zo as Z
from repro_torch.data.pipeline import round_batches
from repro_torch.data.synthetic import GaussianMixtureImages
from repro_torch.distributed.mesh import Mesh, init_distributed, \
    make_replay_mesh
from repro_torch.models import cnn as CNN
from repro_torch.tree import tree_map

# the reference's bar for sharded against flat (tests/test_seed_replay.py)
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 240
N, H, PAIRS, LR = 7, 2, 2, 1e-2
MASK = np.array([1., 1., 0., 1., 1., 0., 1.], np.float32)
ROUND_N, ROUND_H = 3, 2
ROUND_MU, ROUND_LR = RP.THREEFRY_RATES["sphere"]
ROUND_KEY = np.array([0, 9], np.uint32)              # PRNGKey(9)


@pytest.fixture(scope="module")
def ref():
    """The inputs (numpy) and JAX's flat replays."""
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (12, 6)),
              "b": {"c": jnp.linspace(-1.0, 1.0, 7)}}
    zo = JZ.ZOConfig(mu=1e-3, n_pairs=PAIRS)
    keys = JZ.fold_in_range(jax.random.PRNGKey(42), N)
    coeffs = jax.random.normal(jax.random.PRNGKey(1), (N, H, PAIRS))
    seeds = JO.fold_seed(jnp.int32(3), jnp.arange(N))
    # one compile a stream: no mask is a mask of ones
    threefry = jax.jit(lambda m: JAG.seed_replay_aggregate(
        params, keys, coeffs, LR, zo, m))
    kernel = jax.jit(lambda m: JAG.seed_replay_aggregate_kernel(
        params, seeds, coeffs, LR, m))
    want = {}
    for mname, m in (("none", np.ones_like(MASK)), ("mask", MASK)):
        want[f"threefry_{mname}"] = threefry(m)
        want[f"kernel_{mname}"] = kernel(m)
    want = {k: jax.tree.map(np.asarray, v) for k, v in want.items()}

    # the port's CNN init and data (JAX's init and data cost ~14 s more
    # here; the data is the reference's bit for bit, test_torch_data.py)
    cfg = CNN.CNNConfig(**RP.CNN_KW)
    cnn_params = tree_map(lambda t: t.numpy(),
                          CNN.init_cnn(cfg, seed=0, device="cpu"))
    ds = GaussianMixtureImages(classes=RP.CNN_KW["classes"], hw=8, noise=0.5)
    rb = {k: v.numpy() for k, v in round_batches(
        ds, R.PRNGKey(3), ROUND_N, ROUND_H, 4).items()}

    np_params = jax.tree.map(np.asarray, params)
    poisoned = np.asarray(coeffs).copy()
    poisoned[2] = 1e6                               # a masked client
    inputs = {**RANKS.flatten(np_params, "agg_params"),
              **RANKS.flatten(cnn_params, "cnn_params"),
              "keys": np.asarray(keys), "seeds": np.asarray(seeds),
              "coeffs": np.asarray(coeffs), "poisoned": poisoned,
              "mask": MASK, "lr": np.float64(LR),
              "rb_inputs": rb["inputs"], "rb_labels": rb["labels"],
              "round_key": ROUND_KEY,
              "round_rates": np.array([ROUND_MU, ROUND_LR,
                                       RP.THREEFRY_SERVER_LR]),
              "round_nh": np.array([ROUND_N, ROUND_H])}
    return {"inputs": inputs, "want": want, "cnn_params": cnn_params}


def _by_path(tree):
    return {p: np.asarray(t) for p, t in RANKS.tree_leaves_with_path(tree)}


def _close(got_flat, prefix, want_tree, **tol):
    want = _by_path(want_tree)
    got = {k.partition("|")[2]: v for k, v in got_flat.items()
           if k.partition("|")[0] == prefix}
    assert set(got) == set(want), (prefix, sorted(got), sorted(want))
    for p, b in want.items():
        if tol:
            np.testing.assert_allclose(got[p], b, err_msg=f"{prefix} {p}",
                                       **tol)
        else:
            np.testing.assert_array_equal(got[p], b,
                                          err_msg=f"{prefix} {p}")


def _port_inputs(ref):
    inp = ref["inputs"]
    params = RANKS.unflatten(inp, "agg_params")
    return (params, inp["keys"], [int(s) for s in inp["seeds"]],
            torch.tensor(inp["coeffs"]))


def _agg(stream, params, keys, seeds, coeffs, mask, **kw):
    if stream == "threefry":
        return AG.seed_replay_aggregate(
            params, keys, coeffs, LR, Z.ZOConfig(mu=1e-3, n_pairs=PAIRS),
            mask, **kw)
    return AG.seed_replay_aggregate_kernel(params, seeds, coeffs, LR, mask,
                                           **kw)


def _equal(a, b):
    la, lb = RANKS.tree_leaves_with_path(a), RANKS.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["threefry", "kernel"])
@pytest.mark.parametrize("mname", ["none", "mask"])
def test_flat_walk_matches_jax_and_chunks_are_bit_equal(ref, stream, mname):
    params, keys, seeds, coeffs = _port_inputs(ref)
    mask = None if mname == "none" else torch.as_tensor(MASK)
    flat = _agg(stream, params, keys, seeds, coeffs, mask)
    _close(RANKS.flatten(flat, "flat"), "flat",
           ref["want"][f"{stream}_{mname}"], **RP.PARAM_TOL)
    for chunk in (1, 3, 7, 20, 64):
        _equal(_agg(stream, params, keys, seeds, coeffs, mask, chunk=chunk),
               flat)


def test_one_rank_shard_is_the_flat_walk(ref):
    """A one-rank gloo group: ``shard="clients"`` over an explicit mesh
    and over the default one (``mesh=None``) is the flat walk bit for
    bit, and with ``chunk`` too."""
    params, keys, seeds, coeffs = _port_inputs(ref)
    mask = torch.as_tensor(MASK)
    assert init_distributed("cpu")
    try:
        mesh = make_replay_mesh()
        for stream in ("threefry", "kernel"):
            flat = _agg(stream, params, keys, seeds, coeffs, mask)
            _equal(_agg(stream, params, keys, seeds, coeffs, mask,
                        shard="clients", mesh=mesh), flat)
            _equal(_agg(stream, params, keys, seeds, coeffs, mask,
                        shard="clients"), flat)
            _equal(_agg(stream, params, keys, seeds, coeffs, mask,
                        shard="clients", mesh=mesh, chunk=3), flat)
    finally:
        dist.destroy_process_group()


def test_replay_mesh_validation(ref):
    params, keys, seeds, coeffs = _port_inputs(ref)
    with pytest.raises(ValueError, match="not in mesh"):
        AG._resolve_replay_mesh("clients", Mesh({"model": 1}))
    with pytest.raises(ValueError, match="not in mesh"):
        _agg("kernel", params, keys, seeds, coeffs, None, shard="clients",
             mesh=Mesh({"data": 2, "model": 1}))
    with pytest.raises(ValueError, match="no process group"):
        _agg("kernel", params, keys, seeds, coeffs, None, shard="clients",
             mesh=Mesh({"clients": 2}))
    with pytest.raises(ValueError, match="chunk"):
        _agg("kernel", params, keys, seeds, coeffs, None, chunk=0)
    # the replay starts no process group of its own
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        _agg("kernel", params, keys, seeds, coeffs, None, shard="clients")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# across ranks: one spawn per world size
# ---------------------------------------------------------------------------

def _spawn(world, workdir, inputs):
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ctx = mp.start_processes(RANKS.run_rank, args=(world, workdir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world}-rank spawn ran past "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def spawned(ref, tmp_path_factory):
    """``spawned(world)``: the ranks' results of the one spawn of that
    world size (run on first use)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, str(tmp_path_factory.mktemp(
                f"world{world}")), ref["inputs"])
        return cache[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_replay_matches_jax(ref, spawned, world):
    """Every rank: ``shard`` and ``shard + chunk=3`` against JAX's flat
    replay, masked and unmasked, both streams, and ``chunk`` changing
    nothing; the poisoned masked client changes nothing; the flat walk
    too."""
    outs = spawned(world)
    for out in outs:
        for stream in ("threefry", "kernel"):
            for mname in ("none", "mask"):
                tag = f"{stream}_{mname}"
                want = ref["want"][tag]
                for mode in ("flat", "shard", "shard_c3"):
                    _close(out, f"{tag}_{mode}", want, **SHARD_TOL)
                for k, v in out.items():
                    if k.startswith(f"{tag}_shard_c3|"):
                        np.testing.assert_array_equal(
                            v, out[k.replace("_shard_c3|", "_shard|")],
                            err_msg=k)
            poison = {k.replace("_mask_poison|", "_mask_shard|"): v
                      for k, v in out.items()
                      if f"{stream}_mask_poison|" in k}
            assert poison
            for k, v in poison.items():
                np.testing.assert_array_equal(v, out[k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree_bit_for_bit(spawned, world):
    outs = spawned(world)
    assert len(outs) == world
    for out in outs[1:]:
        assert set(out) == set(outs[0])
        for k, v in out.items():
            np.testing.assert_array_equal(v, outs[0][k], err_msg=k)


def test_sharded_rounds(ref, spawned):
    """World 2: the sharded seed-replay round and the async round at
    ``buffer_k=0``, sharded, against the unsharded ones within the
    sharded bar, and the chunked async round bit for bit (the server's
    state bit for bit in all)."""
    out = spawned(2)[0]
    round_ref = {k.partition("|")[2]: v for k, v in out.items()
                 if k.startswith("round_ref|")}
    assert round_ref
    for p, b in round_ref.items():
        if p.startswith("client/"):
            np.testing.assert_allclose(out[f"round|{p}"], b, err_msg=p,
                                       **SHARD_TOL)
        else:
            np.testing.assert_array_equal(out[f"round|{p}"], b, err_msg=p)
    assert any(not np.array_equal(out[f"round|client/{p}"], b)
               for p, b in _by_path(ref["cnn_params"]["client"]).items())
    async_ref = {k.partition("|")[2]: v for k, v in out.items()
                 if k.startswith("async_ref|")}
    assert async_ref
    for p, b in async_ref.items():
        np.testing.assert_array_equal(out[f"async_chunk|{p}"], b,
                                      err_msg=p)
        if p.startswith("client/"):
            np.testing.assert_allclose(out[f"async_shard|{p}"], b,
                                       err_msg=p, **SHARD_TOL)
        else:
            np.testing.assert_array_equal(out[f"async_shard|{p}"], b,
                                          err_msg=p)
