"""The port's ResNet CNN split against :mod:`repro.models.cnn` on
``smoke_config()`` and 8x8 images: same params (through the bridge),
same images and labels from a numpy seed.  Tree paths and shapes, the
client / aux / server forwards, the fused dual-probe client loss, and one
HERON round.  ``client_blocks=2`` puts a stride-2 block with its 1x1
``proj`` conv on the client, so the perturbed stride-2 im2col runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet18_cifar import smoke_config as jax_smoke_config
from repro.core import protocols as JP
from repro.core import zo as JZ
from repro.kernels import ops as JO
from repro.models import cnn as JCNN
from repro.optim import optimizers as JOPT
from repro_torch.bridge import from_jax
from repro_torch.configs.resnet18_cifar import smoke_config
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.kernels import ops as O
from repro_torch.models import cnn as CNN
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
# as tests/test_torch_round.py: f32 losses differ by a few ulps between
# the frameworks, a coefficient divides them by mu, and the server's
# first AdamW step is ~g/|g|, so mu=1e-2, lr=1e-3, server lr 1e-4
MU, LR, SERVER_LR, N = 1e-2, 1e-3, 1e-4, 2
PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
KEY = jax.random.PRNGKey(9)


def _cfgs(client_blocks):
    jcfg = dataclasses.replace(jax_smoke_config(),
                               client_blocks=client_blocks)
    cfg = dataclasses.replace(smoke_config(), client_blocks=client_blocks,
                              forward_impl="kernel")
    return jcfg, cfg


@pytest.fixture(scope="module", params=[1, 2], ids=["cb1", "cb2"])
def setup(request):
    jcfg, cfg = _cfgs(request.param)
    p = JCNN.init_cnn(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jax.tree.map(np.asarray, p)


def _batch(b=4, hw=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, (b,))
    return x, y


def _sorted_leaves(tree):
    # jax.tree.map sorted the dict keys; walk the port's tree the same way
    return jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree))


def test_init_cnn_tree_paths_and_shapes(setup):
    _, cfg, params = setup
    ours = CNN.init_cnn(cfg, seed=0, device="cpu")
    ref = sorted((p, a.shape, str(a.dtype)) for p, a in
                 tree_leaves_with_path(params))
    got = sorted((p, tuple(t.shape), str(t.dtype).split(".")[-1])
                 for p, t in tree_leaves_with_path(ours))
    assert got == ref
    # the stride-2 block's 1x1 proj is on the client only at cb2
    assert any(p.startswith("client/") and "/proj" in p
               for p, _, _ in ref) == (cfg.client_blocks == 2)


def test_forwards_and_loss_match_jax(setup):
    jcfg, cfg, params = setup
    x, y = _batch()
    tp = from_jax(params, device="cpu")
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)

    s_ref = JCNN.client_forward(params["client"], x, jcfg)
    s = CNN.client_forward(tp["client"], tx, cfg)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)

    a_ref = JCNN.aux_logits(params["client"], s_ref, jcfg)
    a = CNN.aux_logits(tp["client"], s, cfg)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), **TOL)

    lg_ref = JCNN.server_logits(params["server"], s_ref, jcfg)
    lg = CNN.server_logits(tp["server"], s, cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)

    np.testing.assert_allclose(float(CNN.xent(lg, ty)),
                               float(JCNN.xent(lg_ref, y)), rtol=1e-6)
    assert float(CNN.accuracy(lg, ty)) == float(JCNN.accuracy(lg_ref, y))


def test_stride2_same_padding_matches_xla():
    """XLA's SAME pads (0, 1) for a 3x3 conv at stride 2 on an even size;
    the library conv and the im2col path both follow it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    ref = np.asarray(JCNN.conv(w, x, 2))
    got = CNN.conv(torch.as_tensor(w), torch.as_tensor(x), 2)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    cols, ho, wo = CNN._im2col(torch.as_tensor(x), 3, 3, 2)
    jcols, jho, jwo = JCNN._im2col(x, 3, 3, 2)
    assert (ho, wo) == (jho, jwo) == (4, 4)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))


@pytest.mark.parametrize("mu", [0.0, 1e-2])
@pytest.mark.parametrize("impl", ["kernel", "kernel_interpret"])
def test_client_dual_loss_matches_jax(setup, mu, impl):
    """l_clean, l_pert and the smashed data of one fused dual-probe pass;
    the JAX side runs its xla emulation ("kernel" on CPU) or the Pallas
    kernels in interpret mode ("kernel_interpret")."""
    jcfg, cfg, params = setup
    jcfg = dataclasses.replace(jcfg, forward_impl=impl)
    x, y = _batch()
    cp = params["client"]
    jseeds = JO.leaf_seed_tree(cp, jnp.int32(-4321))
    seeds = O.leaf_seed_tree(cp, -4321)
    l0r, lpr, sr = jax.jit(JP.cnn_api(jcfg).client_dual_loss)(
        cp, {"inputs": x, "labels": y}, jseeds, mu)
    l0, lp, s = P.cnn_api(cfg).client_dual_loss(
        from_jax(cp, device="cpu"),
        {"inputs": torch.as_tensor(x), "labels": torch.as_tensor(y)},
        seeds, mu)
    np.testing.assert_allclose(float(l0), float(l0r), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(lpr), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)
    if mu == 0.0:
        assert float(l0) == float(lp)
    else:
        assert float(l0) != float(lp)


def _round_batch(h, b=4, hw=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, h, b, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, (N, h, b))
    return {"inputs": x, "labels": y}


@pytest.mark.parametrize("h", [1, 2])
def test_round_params_match_jax(setup, h):
    jcfg, cfg, params = setup
    rb = _round_batch(h)
    jcfg = dataclasses.replace(jcfg, forward_impl="kernel")
    jsopt = JOPT.adamw(SERVER_LR)
    jstate = {"client": params["client"], "server": params["server"],
              "opt_server": jsopt.init(params["server"])}
    jrnd = jax.jit(JP.make_fed_round(
        JP.cnn_api(jcfg), "heron", JZ.ZOConfig(mu=MU, n_pairs=1),
        JP.FedConfig(n_clients=N, h=h), JOPT.zo_sgd(LR), jsopt,
        uplink="seed_replay", client_lr=LR))
    ref, jm = jrnd(jstate, rb, KEY)

    sopt = OPT.adamw(SERVER_LR)
    tp = from_jax(params, device="cpu")
    state = {"client": tp["client"], "server": tp["server"],
             "opt_server": sopt.init(tp["server"])}
    rnd = P.make_fed_round(P.cnn_api(cfg), "heron",
                           Z.ZOConfig(mu=MU, n_pairs=1),
                           P.FedConfig(n_clients=N, h=h), OPT.zo_sgd(LR),
                           sopt, uplink="seed_replay", client_lr=LR)
    new, m = rnd(state, {k: torch.as_tensor(v) for k, v in rb.items()},
                 np.asarray(KEY))

    for part in ("client", "server"):
        got = _sorted_leaves(new[part])
        want = jax.tree.leaves(jax.tree.map(np.asarray, ref[part]))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **PARAM_TOL)
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert m["uplink_bytes"] == float(jm["uplink_bytes"])
    assert m["uplink_bytes_dense"] == float(jm["uplink_bytes_dense"])
    assert any(not np.array_equal(a, b) for a, b in zip(
        _sorted_leaves(new["client"]), jax.tree.leaves(params["client"])))
