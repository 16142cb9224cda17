"""The placement layer of the datacenter step's mesh mode, and its
two-rank cases.

In process, against :mod:`repro`:

* ``transformer.param_axes`` is the reference's ``init_lm(None, cfg,
  mode="axes")`` leaf for leaf, for gpt2, every dense config, qwen2-vl-2b
  and seamless-m4t-medium (``dec_embed``, the decoder's ``cross``);
* ``AxisRules.sharding_for`` gives the reference's ``spec_for`` decision
  on each shape (its fallbacks included: gpt2-tiny's vocab 211 padded
  to 256, qwen2-1.5b's two kv heads on a model axis of 4) and bounds
  that tile each dim; ``place_batch`` cuts the batch the same way;
* the plain versions of K2 and K4 on a column slab of W with its
  ``col_offset`` are the full-width call's columns bit for bit;
* a rank's slab of the kernel stream (K1's segments of a slab:
  accumulate and field modes) and of the threefry gaussian draw is that
  slab of the unsharded draw bit for bit;
* a rank's slab of each recurrent leaf on both streams, bit for bit;
* every family builds on a model axis (the recurrent, vlm and enc-dec
  ones with sharded mixer, attention, ``cross`` and ``dec_embed``
  leaves); a KV cache holds the kv heads the rank's attention reads;
  the decode engine refuses a data axis above 1.

Across two gloo ranks (one spawn, ``torch_train_mesh_ranks.py``):
recurrentgemma's smoke config on the (2, 1) mesh and gpt2-tiny's HERON
step on (1, 2) against the unsharded step, the latter also against JAX's
single-device jitted step at ``PARAM_TOL`` (the kernel stream; the
threefry stream is held so in ``test_torch_train_mesh.py``);
recurrentgemma's smoke config on (1, 2) (HERON on both streams, every
first-order method) and xlstm's (HERON on both streams, CSE-FSL; AdamW
eps 1e-3) against the unsharded step, their kernel-stream HERON steps
also against JAX's; each recurrent mixer alone on (1, 2) against the
whole block, and the reduce-scatter pair against a single-process sum;
qwen3-moe's smoke HERON step on (1, 2) at a capacity no slab fills and
kimi-k2's with Adafactor on the server against the unsharded step;
qwen2-vl-2b's smoke config on (1, 2) (HERON on both streams and in the
score probe, M-RoPE grid ids on the vision stub's batch) and
seamless-m4t-medium's (HERON on both streams, SFLV2 through the decoder's
cross sub-blocks) against the unsharded step, qwen2-vl's threefry step
and seamless's kernel-stream step also against JAX's; seamless's cross
sub-block alone on (1, 2) against the whole sub-block; the
expert-parallel ``moe_ep`` on (1, 2) and (2, 1) against the reference's
jitted ``moe_ep`` on Auto-axes meshes of forced host devices
(``torch_moe_ep_cases``); the
threefry sphere's slabs and its all-reduced norm within 4 f32 ulps of
the unsharded ones; a checkpoint saved on (1, 2) (rank 0 writing the
gathered state), restored on one device, giving the mesh's next step
(gpt2-tiny, recurrentgemma and seamless); the bridge cutting seamless's
tree to its slabs; the driver on two ranks (qwen2-1.5b and seamless);
serving on (1, 2) (``torch_serve_mesh_ranks``): the engines of
qwen2-1.5b, recurrentgemma, xlstm and qwen3-moe against the unsharded
engine and the JAX package's (``jax_serve_reference.py``, beside the
spawn), seamless's token loop, the MoE at one token a row, each
recurrent mixer's state and the attention layer's KV cache through a
prefill and a decode step; gpt2-tiny's FSL-SAGE step on (1, 2) with
remat on equal to the step with remat off bit for bit."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_moe_ep_cases as MC
import torch_round_parity as RP
import torch_serve_mesh_cases as SC
import torch_train_mesh_ranks as RANKS
from repro.configs import command_r_35b as JC, gemma2_27b as JG
from repro.configs import gpt2 as JGPT2, qwen2_1_5b as JQ, qwen2_5_32b as JQ5
from repro.configs import qwen2_vl_2b as JVL, seamless_m4t_medium as JSM
from repro.distributed import sharding as JS
from repro.models import transformer as JT
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import command_r_35b, gemma2_27b, gpt2
from repro_torch.configs import qwen2_1_5b, qwen2_5_32b, qwen2_vl_2b
from repro_torch.configs import seamless_m4t_medium
from repro_torch.configs.registry import get_config
from repro_torch.core import prng as R
from repro_torch.core import decode as D
from repro_torch.core import protocols as P
from repro_torch.core import zo as Z
from repro_torch.data.pipeline import place_batch
from repro_torch.distributed import sharding as S
from repro_torch.distributed.mesh import Mesh, make_local_mesh
from repro_torch.kernels import noise as N
from repro_torch.kernels import ops as O
from repro_torch.kernels import zo_matmul as ZM
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as OPT
from repro_torch.tree import tree_leaves_with_path

SPAWN_TIMEOUT_S = 240
DENSE = {"gpt2-tiny": (JGPT2.gpt2_tiny, gpt2.gpt2_tiny),
         "gpt2-small": (JGPT2.gpt2_small, gpt2.gpt2_small),
         "gpt2-medium": (JGPT2.gpt2_medium, gpt2.gpt2_medium),
         "qwen2-1.5b": (JQ.full_config, qwen2_1_5b.full_config),
         "qwen2.5-32b": (JQ5.full_config, qwen2_5_32b.full_config),
         "command-r-35b": (JC.full_config, command_r_35b.full_config),
         "gemma2-27b": (JG.full_config, gemma2_27b.full_config)}
MODALITY = {"qwen2-vl-2b": (JVL.full_config, qwen2_vl_2b.full_config),
            "seamless-m4t-medium": (JSM.full_config,
                                    seamless_m4t_medium.full_config)}


def _jax_axes(tree, path=""):
    """``{path: names}`` of the reference's axes tree (a leaf is a tuple
    of names)."""
    if isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                       for e in tree):
        return {path: tree}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_jax_axes(v, f"{path}/{k}" if path else str(k)))
    return out


@pytest.mark.parametrize("arch", list(DENSE) + list(MODALITY))
def test_param_axes_match_reference(arch):
    jcfg, cfg = (f() for f in {**DENSE, **MODALITY}[arch])
    want = _jax_axes(JT.init_lm(None, jcfg, mode="axes"))
    got = {p: tuple(lg) for p, lg in tree_leaves_with_path(
        T.param_axes(cfg))}
    assert got == want


class _Shape:
    """A mesh as the reference's rules read it: its named sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


# (mesh, global shape, logical axes): gpt2-tiny's padded vocab, qwen2-
# 1.5b smoke's wk (two kv heads of 16) and its k activation on model 4,
# d_ff, a batch that does not divide, heads of a production config
SPEC_CASES = [
    ({"data": 2, "model": 2}, (256, 64), ("vocab", "d_model")),
    ({"data": 1, "model": 4}, (256, 64), ("vocab", "d_model")),
    ({"data": 1, "model": 4}, (64, 32), ("d_model", "kv_heads")),
    ({"data": 1, "model": 4}, (2, 16, 2, 16), ("batch", None, "kv_heads",
                                               None)),
    ({"data": 2, "model": 2}, (4, 16, 4, 16), ("batch", None, "heads",
                                               None)),
    ({"data": 2, "model": 2}, (3, 16, 64), ("batch", None, None)),
    ({"data": 2, "model": 2}, (2, 64, 256), ("layers", "d_model", "d_ff")),
    ({"data": 2, "model": 4}, (1536, 12 * 128), ("d_model", "heads")),
    ({"data": 1, "model": 4}, (12 * 128, 1536), ("heads", "d_model")),
]


@pytest.mark.parametrize("mesh,shape,logical", SPEC_CASES)
def test_sharding_for_matches_spec_for(mesh, shape, logical):
    want = JS.AxisRules(mesh=_Shape(mesh), enable_fsdp=False).spec_for(
        shape, logical)
    want = tuple(want) + (None,) * (len(shape) - len(tuple(want)))
    seen = {}
    for d in range(mesh["data"]):
        for m in range(mesh["model"]):
            rules = S.AxisRules(mesh=Mesh(mesh, coords={"data": d,
                                                        "model": m}),
                                enable_fsdp=False)
            pl = rules.sharding_for(shape, logical)
            assert pl.spec == want
            seen[pl.bounds] = pl
    # the slabs of each dim tile it: as many distinct slabs as its axes'
    # size, each of the same length
    for i, dim in enumerate(shape):
        axes = next(iter(seen.values())).dim_axes(i)
        n = int(np.prod([mesh[a] for a in axes])) if axes else 1
        starts = sorted({b[i][0] for b in seen})
        assert starts == [k * dim // n for k in range(n)]
    assert S.AxisRules(mesh=None).sharding_for(shape, logical) is None


def test_spec_fallbacks():
    """The two fallbacks the issue names: gpt2-tiny's vocab 211 pads to
    256, which a model axis of 4 splits; qwen2-1.5b's two kv heads do not
    split on it, while their 32 wk columns do (below a head)."""
    assert gpt2.gpt2_tiny().vocab_padded == 256
    rules = S.AxisRules(mesh=Mesh({"data": 1, "model": 4},
                                  coords={"model": 1}), enable_fsdp=False)
    assert rules.sharding_for((256, 64), ("vocab", "d_model")).bounds == \
        ((64, 128), (0, 64))
    assert rules.spec_for((2, 16, 2, 16), ("batch", None, "kv_heads",
                                           None))[2] is None
    assert rules.spec_for((64, 32), ("d_model", "kv_heads")) == \
        (None, "model")


def test_place_batch_cuts_the_data_axis():
    ids = torch.arange(4 * 6).reshape(4, 6)
    pos = torch.arange(6).expand(3, 4, 6)
    for d in range(2):
        rules = S.AxisRules(mesh=Mesh({"data": 2, "model": 2},
                                      coords={"data": d, "model": 1}),
                            enable_fsdp=False)
        b = place_batch({"inputs": ids, "positions": pos}, "cpu", rules)
        assert torch.equal(b["inputs"], ids[2 * d:2 * d + 2])
        assert torch.equal(b["positions"], pos[:, 2 * d:2 * d + 2])
        assert b["batch_split"] is True
        # 3 rows do not divide: replicated, as spec_for falls back
        odd = place_batch({"inputs": ids[:3]}, "cpu", rules)
        assert torch.equal(odd["inputs"], ids[:3])
        assert odd["batch_split"] is False
    assert place_batch({"x": ids}, "cpu", S.AxisRules(mesh=None))["x"] \
        .data_ptr() == ids.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mp", [2, 4])
def test_k2_k4_plain_col_offset_is_full_width_columns(dtype, mp):
    g = torch.Generator().manual_seed(0)
    xa, xb = (torch.randn((24, 64), generator=g).to(dtype) for _ in "ab")
    w = torch.randn((64, 128), generator=g).to(dtype)
    seed, row_offset, mu = 12345, 3 * 64, 0.05
    fa, fb = ZM.zo_dual_matmul(xa, xb, w, seed, 0.0, mu,
                               row_offset=row_offset)
    f4 = ZM.zo_matmul(xa, w, seed, mu, row_offset=row_offset)
    n = 128 // mp
    for m in range(mp):
        cols = slice(m * n, (m + 1) * n)
        ws = w[:, cols].contiguous()
        a, b = ZM.zo_dual_matmul(xa, xb, ws, seed, 0.0, mu,
                                 row_offset=row_offset, col_offset=m * n)
        assert torch.equal(a, fa[:, cols]) and torch.equal(b, fb[:, cols])
        assert torch.equal(ZM.zo_matmul(xa, ws, seed, mu,
                                        row_offset=row_offset,
                                        col_offset=m * n), f4[:, cols])
    # col_offset 0 is the call without it
    a, b = ZM.zo_dual_matmul(xa, xb, w, seed, 0.0, mu,
                             row_offset=row_offset, col_offset=0)
    assert torch.equal(a, fa) and torch.equal(b, fb)
    # the noise of a slab is the field's columns at any width (the CPU
    # BLAS may block a narrower product differently, so the products are
    # held at the width above)
    full = N.uniform_noise(seed, (96, 8960), row_offset, device="cpu")
    n = 8960 // mp
    for m in range(mp):
        assert torch.equal(N.uniform_noise(seed, (96, n), row_offset,
                                           m * n, device="cpu"),
                           full[:, m * n:(m + 1) * n])


# (global shape, logical axes): a stacked column slab, a stacked row slab
# (one K1 segment a layer), a vocab row slab, a column-slab bias, a
# replicated norm scale
SLAB_LEAVES = {"wq": ((3, 64, 128), ("layers", "d_model", "heads")),
               "wo": ((3, 128, 64), ("layers", "heads", "d_model")),
               "table": ((256, 64), ("vocab", "d_model")),
               "b": ((3, 128), ("layers", "heads")),
               "scale": ((3, 64), ("layers", "d_model")),
               # the MoE's expert and router slabs
               "up": ((3, 4, 16, 8), ("layers", "experts", "d_model",
                                      "expert_ff")),
               "router": ((3, 16, 4), ("layers", "d_model", "experts"))}


def _slab_rules(mp, m):
    return S.AxisRules(mesh=Mesh({"data": 1, "model": mp},
                                 coords={"model": m}), enable_fsdp=False)


@pytest.mark.parametrize("mp", [2, 4])
def test_kernel_stream_slabs_are_the_unsharded_draw(mp):
    full = {k: torch.zeros(s) for k, (s, _) in SLAB_LEAVES.items()}
    seeds = O.leaf_seed_tree(full, 77)
    want = O.accumulate_direction_tree(
        {k: v.clone() for k, v in full.items()}, seeds, 0.5)
    field = O.kernel_direction_tree(full, seeds)
    for m in range(mp):
        rules = _slab_rules(mp, m)
        places = {k: rules.sharding_for(s, lg)
                  for k, (s, lg) in SLAB_LEAVES.items()}
        slab = {k: torch.zeros(places[k].local_shape) for k in full}
        got = O.accumulate_direction_tree(slab, seeds, 0.5, places)
        got_field = O.kernel_direction_tree(slab, seeds, places)
        for k in full:
            assert torch.equal(got[k], S.shard(want[k], places[k])), k
            assert torch.equal(got_field[k],
                               S.shard(field[k], places[k])), k
        # a row slab of a stacked leaf is one segment a layer
        assert len(O.leaf_segments(1, places["wo"])) == 3
        assert len(O.leaf_segments(1, places["wq"])) == 1
        # an expert slab is one row window of a layer's (E*d, f) view
        assert len(O.leaf_segments(1, places["up"])) == 3


@pytest.mark.parametrize("mp", [2, 4])
def test_threefry_gaussian_slabs_are_the_unsharded_draw(mp):
    key = R.PRNGKey(11)
    full = {k: torch.zeros(s) for k, (s, _) in SLAB_LEAVES.items()}
    want = Z.normal_like(key, full)
    for m in range(mp):
        rules = _slab_rules(mp, m)
        places = {k: rules.sharding_for(s, lg)
                  for k, (s, lg) in SLAB_LEAVES.items()}
        got = Z.normal_like(key, S.shard_tree(full, places), places)
        for k in full:
            assert torch.equal(got[k], S.shard(want[k], places[k])), k
    assert Z.tree_size(S.shard_tree(full, places), places) == \
        Z.tree_size(full)
    # a slab draw reads the global counters: a 2-D window in the middle
    bounds = ((5, 9), (3, 40))
    np.testing.assert_array_equal(
        R.normal(key, (16, 64), bounds=bounds).numpy(),
        R.normal(key, (16, 64))[5:9, 3:40].numpy())


@pytest.mark.parametrize("kernel", [False, True], ids=["threefry",
                                                     "kernel"])
def test_async_server_replays_slabs(kernel):
    """``AsyncReplayServer(shardings=)`` on each rank's slabs of the
    global params (model 2) flushes to the slabs of the unsharded
    server's new global, bit for bit (gaussian threefry draws of the
    slabs' counters; K1 segments of the slabs)."""
    from repro_torch.fed import AsyncReplayServer
    g = torch.Generator().manual_seed(1)
    full = {k: torch.randn(s, generator=g) for k, (s, _) in
            SLAB_LEAVES.items()}
    zo = Z.ZOConfig(scale="gaussian")
    tokens = ([3, -7] if kernel else [R.PRNGKey(3), R.PRNGKey(7)])
    coeffs = torch.randn((2, 1, 2), generator=g)

    def flush(params, shardings=None):
        srv = AsyncReplayServer(params, 1e-2, zo, kernel=kernel,
                                shardings=shardings)
        for cid, (t, c) in enumerate(zip(tokens, coeffs)):
            srv.submit(cid, t, c)
        srv.flush()
        return srv.params

    want = flush(full)
    for m in range(2):
        rules = _slab_rules(2, m)
        places = {k: rules.sharding_for(s, lg)
                  for k, (s, lg) in SLAB_LEAVES.items()}
        got = flush(S.shard_tree(full, places), places)
        for k in full:
            assert torch.equal(got[k], S.shard(want[k], places[k])), k


@pytest.mark.parametrize("arch,leaves", [
    ("recurrentgemma-9b", ("/rec/",)),
    ("xlstm-1.3b", ("/rec/",)),
    ("qwen2-vl-2b", ("/attn/wq/", "/attn/wk/")),
    ("seamless-m4t-medium", ("/attn/wq/", "/cross/wq/", "/cross/wk/",
                             "/cross/wo/", "server/dec_embed/"))])
def test_every_family_takes_the_model_axis(arch, leaves):
    """``lm_api`` takes the recurrent hybrid and xLSTM families (their
    mixers on "lru" / "heads" / "d_ff" slabs), qwen2-vl (its attention
    on the rank's heads) and the enc-dec (its decoder's ``cross``
    sub-blocks and ``dec_embed`` too) on (1, 2): leaves of each named
    kind are cut.  The data axis takes every family."""
    rules = S.AxisRules(mesh=Mesh({"data": 1, "model": 2},
                                  coords={"data": 0, "model": 0}))
    cfg = get_config(arch, smoke=True)
    api = P.lm_api(cfg, rules)
    assert api.rules is rules
    placed = tree_leaves_with_path(api.shardings)
    for kind in leaves:
        assert any(pl.sharded for path, pl in placed if kind in path), kind
    P.lm_api(cfg, S.AxisRules(
        mesh=Mesh({"data": 2, "model": 1}, coords={"data": 0, "model": 0})))


# one layer's leaves of each recurrent mixer, stacked over 3 layers:
# (global shape, logical axes) of recurrentgemma's RG-LRU at lru 64 and
# xlstm's mLSTM / sLSTM at d 32
REC_LEAVES = {
    "in_x": ((3, 64, 64), ("layers", "d_model", "lru")),
    "conv_w": ((3, 4, 64), ("layers", "conv", "lru")),
    "conv_b": ((3, 64), ("layers", "lru")),
    "w_r": ((3, 64, 64), ("layers", "lru", None)),
    "w_r_b": ((3, 64), ("layers", None)),
    "lam": ((3, 64), ("layers", "lru")),
    "out": ((3, 64, 64), ("layers", "lru", "d_model")),
    "up": ((3, 32, 64), ("layers", "d_model", "d_ff")),
    "wq": ((3, 32, 32), ("layers", "d_model", "heads")),
    "down": ((3, 32, 32), ("layers", "d_ff", "d_model")),
    "wx_b": ((3, 128), ("layers", "d_ff")),
    "r": ((3, 32, 128), ("layers", "d_model", "d_ff"))}


@pytest.mark.parametrize("mp", [2, 4])
def test_recurrent_slabs_of_both_streams_are_the_unsharded_draw(mp):
    """A rank's slab of each recurrent leaf, on the threefry stream (the
    gaussian draw) and on the kernel stream (K1's accumulate mode), is
    that slab of the unsharded draw bit for bit."""
    key = R.PRNGKey(13)
    full = {k: torch.zeros(s) for k, (s, _) in REC_LEAVES.items()}
    want = Z.normal_like(key, full)
    seeds = O.leaf_seed_tree(full, 91)
    acc = O.accumulate_direction_tree(
        {k: v.clone() for k, v in full.items()}, seeds, 0.5)
    for m in range(mp):
        rules = _slab_rules(mp, m)
        places = {k: rules.sharding_for(s, lg)
                  for k, (s, lg) in REC_LEAVES.items()}
        assert not places["w_r_b"].sharded and places["w_r"].sharded
        got = Z.normal_like(key, S.shard_tree(full, places), places)
        got_acc = O.accumulate_direction_tree(
            {k: torch.zeros(places[k].local_shape) for k in full}, seeds,
            0.5, places)
        for k in full:
            assert torch.equal(got[k], S.shard(want[k], places[k])), k
            assert torch.equal(got_acc[k], S.shard(acc[k], places[k])), k


def test_engine_refuses_a_data_axis():
    """``DecodeEngine`` with a data axis above 1 raises, naming ROADMAP:
    its slot batch over "data" is not ported (the serve step and the
    prefill take data x model, for the dry run)."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    rules = S.AxisRules(mesh=Mesh({"data": 2, "model": 1},
                                  coords={"data": 0, "model": 0}))
    with pytest.raises(NotImplementedError, match="ROADMAP 7.6b"):
        D.DecodeEngine({}, cfg, device="cpu", rules=rules)


@pytest.mark.parametrize("mp", [2, 4])
def test_kv_cache_holds_the_heads_the_rank_reads(mp):
    """``init_kv_cache(rules=)`` on each coordinate of (1, mp): as many kv
    heads as the rank's attention reads (``AttnTP.kv_heads`` of a k of
    all heads, or its own slab where the axis divides the kv heads),
    for qwen2-1.5b's two kv heads (on 4 below a head) and
    recurrentgemma's one under four q heads."""
    from repro_torch.models import attention as A
    for arch in ("qwen2-1.5b", "recurrentgemma-9b"):
        cfg = get_config(arch, smoke=True)
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        for m in range(mp):
            rules = _slab_rules(mp, m)
            tp = A.AttnTP.of(cfg, rules)
            read = (K // mp if tp.kv_local else
                    tp.kv_heads(torch.zeros((1, 1, K, hd))).shape[2])
            cache = A.init_kv_cache(cfg, 2, 8, local=False, rules=rules)
            assert cache["k"].shape == (2, 8, read, hd) == \
                cache["v"].shape, (arch, m)
            assert tp.n_kv == read == 1, (arch, m)


def test_reduce_scatter_is_the_identity_without_a_live_axis():
    from repro_torch.distributed import tensor_parallel as TP
    x = torch.randn(2, 3, 8)
    for mesh in (None, Mesh({"data": 2, "model": 1},
                            coords={"data": 0, "model": 0})):
        assert TP.reduce_scatter(x, mesh) is x


def test_local_mesh_without_a_group():
    mesh = make_local_mesh(2)            # one device: model falls back
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.groups
    assert mesh.rank("data") == mesh.rank("model") == 0


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

# the recurrent (1, 2) cases held to JAX's single-device step: (tag,
# arch, the server AdamW's eps)
REC_JAX = [("rg_1x2", "recurrentgemma-9b", RP.FO_EPS),
           ("xlstm_1x2", "xlstm-1.3b", RANKS.XLSTM["eps"])]
# the modality (1, 2) cases held to it: (tag, arch, stream).  qwen2-vl's
# on the threefry stream alone: the reference's kernel path concatenates
# M-RoPE ids on their t / h / w axis and crashes (ROADMAP queue 3)
MODALITY_JAX = [("vlm_1x2", "qwen2-vl-2b", "threefry"),
                ("audio_1x2", "seamless-m4t-medium", "kernel")]


@pytest.fixture(scope="module")
def jax_rec_steps():
    """The reference's jitted HERON steps of ``REC_JAX`` (kernel stream)
    and ``MODALITY_JAX``, as futures of a thread that runs while the
    spawn does."""
    with ThreadPoolExecutor(1) as pool:
        steps = {tag: pool.submit(RP.jax_heron_step, "kernel", arch, eps)
                 for tag, arch, eps in REC_JAX}
        steps.update({tag: pool.submit(RP.jax_heron_step, stream, arch)
                      for tag, arch, stream in MODALITY_JAX})
        yield steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_rec_steps):
    MC.start_jax(tmp_path_factory)     # overlap the spawn
    MC.start_jax(tmp_path_factory, *SC.JAX)
    workdir = str(tmp_path_factory.mktemp("world2"))
    return workdir, RANKS.spawn(2, workdir, RP.mesh_step_inputs(),
                                SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("case", [
    f"{tag}_{stream}_{method}" for tag, *_, steps, _ in
    (m[:5] for m in RANKS.MESHES[2]) for stream, method in steps])
def test_two_rank_step_slabs_match_unsharded(ranks, case):
    outs = ranks[1]
    for r, out in enumerate(outs):
        fails = str(out[f"{case}|fail"])
        assert not fails, f"rank {r}:\n{fails}"
    keys = [k for k in outs[0] if k.startswith(case) and "|rep|" in k]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("case", [f"{t}_{s}_{m}" for t, _, _, s, m, _ in
                                  RANKS.REMAT[2]])
def test_remat_mesh_step_equals_remat_off(ranks, case):
    for r, out in enumerate(ranks[1]):
        fails = str(out[f"remat|{case}|fail"])
        assert not fails, f"rank {r}:\n{fails}"


def test_heron_kernel_mesh_step_matches_jax(ranks):
    """gpt2-tiny's HERON step on (1, 2) on the kernel stream, gathered,
    against the reference's jitted single-device step from the same
    params, batch and key (the threefry stream's is in
    ``test_torch_train_mesh.py``, on (2, 2))."""
    RP.assert_mesh_heron_matches_jax(ranks[1][0], "gpt2_1x2_kernel_heron",
                                     "kernel")


@pytest.mark.parametrize("tag", [t for t, _, _ in REC_JAX])
def test_recurrent_heron_kernel_mesh_step_matches_jax(ranks, jax_rec_steps,
                                                      tag):
    """recurrentgemma's and xlstm's smoke HERON steps on (1, 2) on the
    kernel stream (the RG-LRU on its "lru" slabs, the mLSTM on its heads,
    the sLSTM's gates gathered), gathered, against the reference's jitted
    single-device step from the same params, batch and key (xlstm's
    server AdamW at eps 1e-3 on both sides)."""
    RP.assert_mesh_heron_matches_jax(ranks[1][0], f"{tag}_kernel_heron",
                                     jax_step=jax_rec_steps[tag].result())


@pytest.mark.parametrize("tag,stream", [(t, s) for t, _, s in MODALITY_JAX])
def test_modality_heron_mesh_step_matches_jax(ranks, jax_rec_steps, tag,
                                              stream):
    """qwen2-vl-2b's smoke HERON step on (1, 2) on the threefry stream
    (M-RoPE grid ids through each rank's heads) and seamless-m4t-medium's
    on the kernel stream (the decoder's cross sub-blocks on the rank's
    heads, ``dec_embed`` vocab-parallel), gathered, against the
    reference's jitted single-device step from the same params, batch
    and key."""
    RP.assert_mesh_heron_matches_jax(ranks[1][0], f"{tag}_{stream}_heron",
                                     jax_step=jax_rec_steps[tag].result())


@pytest.mark.parametrize("case", [c for c, _ in RANKS.CROSS_LAYERS])
def test_cross_sub_block_on_1x2_matches_unsharded(ranks, case):
    """seamless-m4t-medium's cross sub-block on (1, 2) against the whole
    sub-block (``torch_train_mesh_ranks.cross_layer_cases``): the output,
    the gradients of x and of ``enc_out`` (whole on every rank, entering
    the wk / wv column slabs through ``copy_to``) and every slab's
    gradient; with four kv heads, one (k / v gathered below a head) and
    three q heads (q gathered too)."""
    for r, out in enumerate(ranks[1]):
        fails = str(out[f"cross|{case}|fail"])
        assert not fails, f"rank {r}: {fails}"


@pytest.mark.parametrize("case", [c[0] for c in RANKS.REC_LAYERS[2]])
def test_recurrent_layers_on_1x2_match_unsharded(ranks, case):
    """Each recurrent mixer on (1, 2): the output, the input's gradient
    and every slab's gradient of ``sum(out * w)`` against the whole
    block (``torch_train_mesh_ranks.rec_layer_cases``); the RG-LRU's K6
    scans its rank's 32 of 64 lru channels."""
    for r, out in enumerate(ranks[1]):
        fails = str(out[f"rec|{case}|fail"])
        assert not fails, f"rank {r}: {fails}"
        widths = out[f"rec|{case}|scan_widths"].tolist()
        assert widths == ([32] if case == "rg_lru" else []), widths


@pytest.mark.parametrize("tag", [c[0] for c in RANKS.PREFILL[2]])
def test_sharded_prefill_on_1x2_is_the_unsharded_slab(ranks, tag):
    """The sharded prefill of recurrentgemma, xlstm and kimi-k2 on (1, 2):
    each rank's logits the vocab slab of the unsharded prefill's
    (``torch_train_mesh_ranks.prefill_cases``)."""
    for r, out in enumerate(ranks[1]):
        fails = str(out[f"prefill|{tag}|fail"])
        assert not fails, f"rank {r}: {fails}"
        assert bool(out[f"prefill|{tag}|cut"])


def test_reduce_scatter_pair_on_two_ranks(ranks):
    """``reduce_scatter`` on (1, 2): the rank's slice of the sum of the
    ranks' inputs, and its backward the all-gather of the slices'
    gradients."""
    for out in ranks[1]:
        assert out["rec|reduce_scatter"].all()


def test_lora_dense_on_1x2_matches_unsharded(ranks):
    """A column- and a row-parallel dense layer with LoRA adapters on
    (1, 2) against the whole layer: the output and every slab's gradient
    (``torch_train_mesh_ranks.lora_dense_case``; the column layer's
    replicated ``lora_a`` gradient summed over "model", ROADMAP queue
    3)."""
    for r, out in enumerate(ranks[1]):
        fails = str(out["lora|fail"])
        assert not fails, f"rank {r}: {fails}"


def test_bridge_loads_slabs(ranks):
    """``bridge.from_jax(shardings=)`` cuts each numpy leaf to this rank's
    slab (in process, at every coordinate of model 2) and ``to_numpy``
    gathers the slabs back bit for bit (on the two ranks)."""
    from repro_torch.bridge import from_jax
    g = np.random.default_rng(0)
    full = {k: g.standard_normal(s).astype(np.float32)
            for k, (s, _) in SLAB_LEAVES.items()}
    for m in range(2):
        rules = _slab_rules(2, m)
        places = {k: rules.sharding_for(s, lg)
                  for k, (s, lg) in SLAB_LEAVES.items()}
        got = from_jax(full, "cpu", places)
        for k in full:
            assert torch.equal(got[k], S.shard(torch.as_tensor(full[k]),
                                               places[k])), k
    assert all(bool(out["misc|bridge_roundtrip"]) for out in ranks[1])


def test_bridge_loads_seamless_slabs(ranks):
    """``from_jax(shardings=)`` on seamless-m4t-medium's whole smoke tree
    on (1, 2): every leaf the rank's slab of the numpy leaf, gathered
    back bit for bit by ``to_numpy``, ``dec_embed`` and the decoder's
    ``cross`` leaves among those cut."""
    for out in ranks[1]:
        assert out["misc|bridge_s2s"].all(), out["misc|bridge_s2s"]


def test_sphere_slabs_within_4_ulps(ranks):
    for out in ranks[1]:
        nrm, want = out["misc|sphere_norm"]
        assert abs(nrm - want) <= 4 * np.spacing(np.float32(want))
        keys = [k for k in out if k.startswith("misc|sphere|")]
        assert keys
        for k in keys:
            got, ref = out[k]
            np.testing.assert_allclose(got, ref, rtol=4 * 2.0 ** -23,
                                       atol=0, err_msg=k)


def _assert_checkpoint_restores_on_one_rank(ranks, name, tag):
    workdir, outs = ranks
    assert all(out[f"misc|ckpt_mesh_roundtrip{tag}"].all() for out in outs)
    inp = RP.mesh_step_inputs()
    mu, lr = (float(x) for x in inp["kernel_rates"])
    cfg = RANKS.config(name, "kernel")
    copt, sopt = OPT.zo_sgd(lr), OPT.adamw(RP.FO_SERVER_LR, eps=RP.FO_EPS)
    template = P.init_train_state(
        R.PRNGKey(1), T.init_lm(cfg, device="cpu", key=R.PRNGKey(0)), copt,
        sopt)
    state, step = CKPT.restore(f"{workdir}/ckpt{tag}", template)
    assert step == 1 and state["step"] == 1
    nxt, _ = P.make_train_step(P.lm_api(cfg), "heron",
                               Z.ZOConfig(mu=mu, scale="gaussian"), copt,
                               sopt)(state, RANKS.batch_of(inp, cfg))
    prefix = f"misc|ckpt_next_mesh{tag}|"
    want = {f"{prefix}{p}": v.numpy()
            for p, v in tree_leaves_with_path(nxt["params"])}
    assert sorted(want) == sorted(k for k in outs[0]
                                  if k.startswith(prefix))
    for k, v in want.items():
        np.testing.assert_allclose(outs[0][k], v, err_msg=k,
                                   **RP.PARAM_TOL)


def test_checkpoint_saved_on_mesh_restores_on_one_rank(ranks):
    """The state after a HERON step on (1, 2), saved by rank 0 from the
    gathered slabs, restored into a one-device state: its next step
    equals the mesh's next step (gathered) at ``PARAM_TOL``."""
    _assert_checkpoint_restores_on_one_rank(ranks, "gpt2-tiny", "")


def test_recurrent_checkpoint_saved_on_mesh_restores_on_one_rank(ranks):
    """As above for recurrentgemma's smoke config, its RG-LRU leaves
    saved from their "lru" slabs."""
    _assert_checkpoint_restores_on_one_rank(ranks, "recurrentgemma-9b",
                                            "_rg")


def test_enc_dec_checkpoint_saved_on_mesh_restores_on_one_rank(ranks):
    """As above for seamless-m4t-medium's smoke config: ``dec_embed`` and
    the decoder's ``cross`` leaves saved from their slabs."""
    _assert_checkpoint_restores_on_one_rank(ranks, "seamless-m4t-medium",
                                            "_s2s")


def test_driver_model_parallel_on_two_ranks(ranks, tmp_path, capsys):
    """``launch.train --model-parallel 2`` on two ranks: exit 0, rank 0
    alone prints, the printed losses are the one-device run's (four
    decimals), its checkpoint holds the one-device run's leaves (the
    server's and its optimizer's at ``PARAM_TOL``; the client's HERON
    runs the driver's sphere, whose coefficient scales the losses' last
    ulps by d / mu, so its values are held by the gaussian step tests);
    a longer one-device run resumes from it (the elastic restore)."""
    from repro_torch.launch import train as TRAIN
    workdir, outs = ranks
    (rc, out), (rc1, out1) = outs[0]["misc|driver_run"], \
        outs[1]["misc|driver_run"]
    assert rc == rc1 == "0" and out1 == ""
    one = str(tmp_path / "one")
    capsys.readouterr()
    assert TRAIN.main(RANKS.DRIVER + ["--ckpt-dir", one]) == 0
    want = capsys.readouterr().out

    def losses(text):
        return [ln.split(" (")[0] for ln in text.splitlines()
                if ln.startswith("[train] step")]
    assert losses(out) == losses(want) and len(losses(want)) == 2
    got = np.load(f"{workdir}/driver_ckpt/step_00000002/payload.npz")
    ref = np.load(f"{one}/step_00000002/payload.npz")
    cfg = get_config("qwen2-1.5b", smoke=True)
    paths = [p for p, _ in tree_leaves_with_path(P.init_train_state(
        R.PRNGKey(1), T.init_lm(cfg, device="cpu"), OPT.zo_sgd(1e-3),
        OPT.adamw(1e-4)), sort_keys=True)]
    assert sorted(got) == sorted(ref) == sorted(f"p{i}" for i in
                                                range(len(paths)))
    for i, path in enumerate(paths):
        k = f"p{i}"
        assert got[k].shape == ref[k].shape and np.isfinite(got[k]).all()
        if path.startswith(("params/server", "opt_server")):
            np.testing.assert_allclose(got[k], ref[k], err_msg=path,
                                       **RP.PARAM_TOL)
    capsys.readouterr()
    assert TRAIN.main(RANKS.DRIVER[:-7] + ["3"] + RANKS.DRIVER[-6:] + [
        "--ckpt-dir", f"{workdir}/driver_ckpt"]) == 0
    assert "[train] restored checkpoint at step 2" in capsys.readouterr().out


def test_driver_model_parallel_enc_dec_on_two_ranks(ranks, tmp_path,
                                                    capsys):
    """``launch.train --arch seamless-m4t-medium --smoke --model-parallel
    2`` on two ranks: exit 0, rank 0 alone prints, the printed losses
    are the one-device run's (four decimals)."""
    from repro_torch.launch import train as TRAIN
    (rc, out), (rc1, out1) = (o["misc|driver_run_s2s"] for o in ranks[1])
    assert rc == rc1 == "0" and out1 == ""
    capsys.readouterr()
    assert TRAIN.main(RANKS.driver_args("seamless-m4t-medium") + [
        "--ckpt-dir", str(tmp_path / "one")]) == 0
    want = capsys.readouterr().out

    def losses(text):
        return [ln.split(" (")[0] for ln in text.splitlines()
                if ln.startswith("[train] step")]
    assert losses(out) == losses(want) and len(losses(want)) == 2


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    return MC.jax_results(tmp_path_factory)


@pytest.mark.parametrize("case", MC.world_cases(2))
def test_moe_ep_on_two_ranks_matches_jax(ranks, jax_moe, case):
    MC.assert_ranks_match(ranks[1], case, jax_moe)


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    return MC.jax_results(tmp_path_factory, *SC.JAX)


@pytest.mark.parametrize("tag,arch,cf", [(t, a, cf) for t, a, _, cf in
                                         SC.ENGINES[2]])
def test_engine_on_1x2_matches_unsharded_and_jax(ranks, jax_serve, tag,
                                                 arch, cf):
    """``DecodeEngine(rules=)`` on (1, 2), each rank on its slabs
    (``torch_serve_mesh_ranks.engine_case``; several slots, mixed prompt
    lengths, slots refilled): its greedy streams equal the unsharded port
    engine's, every rank's, and the JAX package's engine's on the same
    params; the logits along them within ``PREFILL_TOL`` (xlstm's at
    ``XLSTM_FLOOR`` x max |logits|).  qwen2-1.5b (dense), recurrentgemma
    (RG-LRU on "lru" slabs, local attention on a ring that the 9-token
    prompts wrap), xlstm (mLSTM heads, sLSTM whole) and qwen3-moe (at a
    capacity no slab fills)."""
    SC.assert_engine_matches(ranks[1], tag, arch, cf, jax_serve)


def test_s2s_token_loop_on_1x2_matches_jax(ranks, jax_serve):
    """seamless-m4t-medium's token loop (``launch/serve.enc_dec_stream``:
    ``make_prompt_consume`` and ``make_serve_step`` with ``rules``) on
    (1, 2): the unsharded loop's tokens and the JAX package's, the logits
    along them within ``PREFILL_TOL``."""
    want = jax_serve["s2s"]
    for r, out in enumerate(ranks[1]):
        fails = str(out["serve|s2s|fail"])
        assert not fails, f"rank {r}:\n{fails}"
        np.testing.assert_array_equal(out["serve|s2s|mesh"],
                                      out["serve|s2s|full"])
        np.testing.assert_array_equal(out["serve|s2s|mesh"], want)


@pytest.mark.parametrize("tag", ["shared0", "shared1"])
def test_moe_ffn_one_token_a_row_on_1x2_matches_unsharded(ranks, tag):
    """``moe_ffn`` on a (16, 1, d) input (a decode step's) under the
    (1, 2) mesh, each rank holding half the experts: the unsharded
    layer's output and its dropped entries (capacity factor 1.0: the
    capacity binds), with and without a shared expert.  It reached
    ``moe_xla`` with the rank's expert slab as if it held every expert
    (ROADMAP queue 3)."""
    for r, out in enumerate(ranks[1]):
        fails = str(out[f"serve|moe1|{tag}|fail"])
        assert not fails, f"rank {r}:\n{fails}"
        got, want = out[f"serve|moe1|{tag}|drops"]
        assert got == want > 0, (r, got, want)


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("mixer", ["rg_lru", "mlstm", "slstm"])
def test_recurrent_state_on_1x2_matches_unsharded(ranks, mixer, decode):
    """Each recurrent mixer on (1, 2): a block prefill into a fresh state
    (``init_*_state(rules=)``) and then one decode step with a slot not
    live, on the rank's slabs against the whole block
    (``torch_serve_mesh_ranks.rec_state_cases``): the output and the
    state slab (the RG-LRU's "lru" channels, the mLSTM's heads and conv
    channels, the sLSTM whole) at ``LAYER_RTOL`` / ``LAYER_ATOL``."""
    for r, out in enumerate(ranks[1]):
        err = str(out[f"serve|rec|{mixer}|error"])
        assert not err, f"rank {r}:\n{err}"
        fails = str(out[f"serve|rec|{mixer}|{int(decode)}|fail"])
        assert not fails, f"rank {r}:\n{fails}"


@pytest.mark.parametrize("decode", [False, True])
def test_attention_cache_on_1x2_matches_unsharded(ranks, decode):
    """The attention layer on (1, 2): a block prefill into a fresh
    per-slot cache (``init_kv_cache(rules=)``) and then one decode step
    with a slot not live, against the whole layer: the output and the
    cache of the kv heads the rank reads, for qwen2-1.5b (a kv head a
    rank), recurrentgemma's local attention (one kv head narrowed to the
    rank's GQA group; a 12-token prompt on a ring of 8) and seamless
    (two kv heads a rank)."""
    for r, out in enumerate(ranks[1]):
        err = str(out["serve|attn|error"])
        assert not err, f"rank {r}:\n{err}"
        fails = str(out[f"serve|attn|{int(decode)}|fail"])
        assert not fails, f"rank {r}:\n{fails}"
