"""The datacenter step's mesh mode (``lm_api(cfg, rules)``,
``make_train_step``, ``place_batch``) across four gloo ranks.

One ``torch.multiprocessing`` spawn of four ranks on a ``FileStore``
(``torch_train_mesh_ranks.py``, which imports only the port) runs
gpt2-tiny and qwen2-1.5b's smoke config on the (2, 2) ("data", "model")
mesh and qwen2-1.5b's on (1, 4) (its two kv heads then split below a
head: k / v are gathered and each rank's one q head meets its GQA
group), one step of HERON on the kernel stream and on the threefry
stream (gaussian, as every threefry step test: the sphere's coefficient
is ``d`` times the losses' rounding) and of every first-order method:

* each rank's slab of every state leaf (params and both optimizer
  states) equals the port's unsharded step's slab at ``PARAM_TOL``
  (rtol 2e-5, atol 1e-6; mu 1e-2), and the losses at rtol 2e-5;
* every replicated leaf is the same bytes on all four ranks;
* HERON on the threefry stream, gathered from the (2, 2) slabs, equals
  JAX's single-device jitted step on gpt2-tiny at ``PARAM_TOL`` (one JAX
  compile);
* ``fault.remesh`` over the four ranks;
* the expert-parallel MoE (``moe_ep``) on the (2, 2) mesh, forward and
  gradients, against the reference's jitted ``moe_ep`` on an Auto-axes
  (2, 2) mesh of 4 forced host devices (``torch_moe_ep_cases``: drops
  and none, a shared expert, a sequence and a batch that do not divide,
  the global view); qwen3-moe-30b-a3b's smoke config in one HERON step
  (kernel stream, mu 1e-2, per-slab drops) gathered from its slabs
  against the reference's sharded jitted step at ``PARAM_TOL``; and
  kimi-k2's smoke config with Adafactor on the server against the
  unsharded Adafactor step (its factored statistics of a cut attention
  leaf are the whole leaf's);
* the recurrent families on the model axis: recurrentgemma's smoke
  config on (2, 2) and xlstm's on (1, 4) (AdamW eps 1e-3), one HERON
  step on the kernel stream each against the unsharded step; each
  recurrent mixer alone on (1, 4), with the edge layouts (an mLSTM
  "heads" slab below a head, an lru width 4 does not divide), and the
  reduce-scatter pair;
* the vlm and enc-dec families on the model axis: qwen2-vl-2b's smoke
  config on (1, 4) (its two kv heads split below a head, gathered and
  narrowed to each rank's q head, with M-RoPE grid ids) and
  seamless-m4t-medium's on (2, 2) (the decoder's cross sub-blocks on the
  rank's heads, ``dec_embed`` vocab-parallel), one HERON step on the
  kernel stream each against the unsharded step;
* the sharded prefill (``make_prefill_step(cfg, rules)``) of gpt2-tiny,
  qwen2-1.5b, qwen3-moe, qwen2-vl and seamless: each rank's logits the
  slab of the unsharded prefill's;
* serving (``torch_serve_mesh_ranks``): qwen2-1.5b's ``DecodeEngine`` on
  (1, 4), its two kv heads below a head (each rank's cache the one kv
  head of its q head's group), against the unsharded engine and the JAX
  package's; gpt2-tiny's cached prefill and serve steps on (2, 2), each
  rank's logits the slab of the unsharded ones';
* qwen3-moe's HERON step on (2, 2) with remat on (the configs' default,
  every case above) equal to the step with remat off bit for bit.

The two-rank cases and the steps held to JAX's single-device step are in
``test_torch_mesh_axes.py``.

A spawn that outlives ``SPAWN_TIMEOUT_S`` is killed and fails its
test."""
import numpy as np
import pytest

import torch_moe_ep_cases as MC
import torch_round_parity as RP
import torch_serve_mesh_cases as SC
import torch_train_mesh_ranks as RANKS

SPAWN_TIMEOUT_S = 240
# the cases held to the unsharded step (the MoE case with per-slab drops
# is held to the reference's sharded step)
CASES = [f"{tag}_{stream}_{method}" for tag, _, _, steps, _, *opts in
         RANKS.MESHES[4] for stream, method in steps
         if not (opts and opts[0].get("jax_step"))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    MC.start_jax(tmp_path_factory)     # overlap the spawn
    MC.start_jax(tmp_path_factory, *SC.JAX)
    return RANKS.spawn(4, str(tmp_path_factory.mktemp("world4")),
                       RP.mesh_step_inputs(), SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_slabs_match_unsharded(ranks, case):
    for r, out in enumerate(ranks):
        fails = str(out[f"{case}|fail"])
        assert not fails, f"rank {r}:\n{fails}"


@pytest.mark.parametrize("case", [f"{t}_{s}_{m}" for t, _, _, s, m, _ in
                                  RANKS.REMAT[4]])
def test_remat_mesh_step_equals_remat_off(ranks, case):
    for r, out in enumerate(ranks):
        fails = str(out[f"remat|{case}|fail"])
        assert not fails, f"rank {r}:\n{fails}"


@pytest.mark.parametrize("tag", [m[0] for m in RANKS.MESHES[4]])
def test_replicated_leaves_equal_across_ranks(ranks, tag):
    keys = [k for k in ranks[0] if k.startswith(tag) and "|rep|" in k]
    assert keys
    for out in ranks[1:]:
        assert sorted(k for k in out if k.startswith(tag)
                      and "|rep|" in k) == sorted(keys)
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("tag", [c[0] for c in RANKS.PREFILL[4]])
def test_sharded_prefill_is_the_unsharded_slab(ranks, tag):
    """``make_prefill_step(cfg, rules)`` on each rank's slabs: its logits
    are the (batch rows, vocab columns) slab of the unsharded prefill's
    at ``RANKS.PREFILL_TOL`` (``torch_train_mesh_ranks.prefill_cases``),
    and a slab, not the whole."""
    for r, out in enumerate(ranks):
        fails = str(out[f"prefill|{tag}|fail"])
        assert not fails, f"rank {r}: {fails}"
        assert bool(out[f"prefill|{tag}|cut"])


def test_heron_threefry_mesh_step_matches_jax(ranks):
    """gpt2-tiny's HERON step on (2, 2) on the threefry stream, gathered,
    against the reference's jitted single-device step from the same
    params, batch and key (the kernel stream's is in
    ``test_torch_mesh_axes.py``, on (1, 2))."""
    RP.assert_mesh_heron_matches_jax(ranks[0], "gpt2_2x2_threefry_heron",
                                     "threefry")


@pytest.mark.parametrize("case", [c[0] for c in RANKS.REC_LAYERS[4]])
def test_recurrent_layers_on_1x4_match_unsharded(ranks, case):
    """Each recurrent mixer on (1, 4) against the whole block
    (``torch_train_mesh_ranks.rec_layer_cases``): the output, the input's
    gradient and every slab's gradient of ``sum(out * w)``.  The RG-LRU's
    K6 scans 16 of 64 lru channels a rank, or all 66 where 4 does not
    divide the width (the rules leave the block whole); the mLSTM with 2
    heads of 16 cuts its "heads" slab below a head (q / k / v gathered,
    every head on every rank)."""
    widths = {"rg_lru": [16], "rg_lru_w66": [66]}.get(case, [])
    for r, out in enumerate(ranks):
        fails = str(out[f"rec|{case}|fail"])
        assert not fails, f"rank {r}: {fails}"
        assert out[f"rec|{case}|scan_widths"].tolist() == widths


def test_reduce_scatter_pair_on_four_ranks(ranks):
    """``reduce_scatter`` on (1, 4): forward the rank's slice of the sum,
    backward the all-gather of the slices' gradients."""
    for out in ranks:
        assert out["rec|reduce_scatter"].all()


def test_lora_dense_on_1x4_matches_unsharded(ranks):
    """``torch_train_mesh_ranks.lora_dense_case`` on (1, 4)."""
    for r, out in enumerate(ranks):
        fails = str(out["lora|fail"])
        assert not fails, f"rank {r}: {fails}"


def test_remesh_over_four_ranks(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["misc|remesh"], [[2, 2], [4, 1]])


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    return MC.jax_results(tmp_path_factory)


@pytest.mark.parametrize("case", MC.world_cases(4))
def test_moe_ep_on_2x2_matches_jax(ranks, jax_moe, case):
    MC.assert_ranks_match(ranks, case, jax_moe)


def test_moe_heron_step_on_2x2_matches_jax_sharded_step(ranks, jax_moe):
    """qwen3-moe-30b-a3b's smoke HERON step on (2, 2), gathered, against
    the reference's jitted step on the Auto-axes (2, 2) mesh: each (data,
    model) token slab dispatched at its own capacity, as the reference's
    ``shard_map`` does."""
    from repro_torch.core import prng as R
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path
    start = {p: v.numpy() for p, v in tree_leaves_with_path(T.init_lm(
        RANKS.config("qwen3-moe-30b-a3b", "kernel"), device="cpu",
        key=R.PRNGKey(0)))}
    MC.assert_step_matches(ranks[0], "moe_2x2_kernel_heron", jax_moe, start)


def test_adafactor_stats_of_a_cut_attention_leaf_are_whole(ranks):
    """kimi-k2's server wq is a column slab on (2, 2): its Adafactor row
    statistic (a mean over the columns) is the whole leaf's, the same
    bytes on every rank and equal to the unsharded step's (the slab
    check), and its column statistic the slab's."""
    vr = "kimi_2x2_kernel_heron|rep|opt_server/v/layers/0/0/attn/wq/w/vr"
    vc = "kimi_2x2_kernel_heron|rep|opt_server/v/layers/0/0/attn/wq/w/vc"
    for out in ranks:
        assert vr in out and vc not in out
        assert not str(out["kimi_2x2_kernel_heron|fail"])


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    return MC.jax_results(tmp_path_factory, *SC.JAX)


def test_engine_on_1x4_matches_unsharded_and_jax(ranks, jax_serve):
    """qwen2-1.5b's ``DecodeEngine`` on (1, 4): its two kv heads split
    below a head, so each rank's caches hold the one kv head its q head
    reads; greedy streams equal to the unsharded engine's, every rank's
    and the JAX package's, the logits along them within
    ``PREFILL_TOL``."""
    (tag, arch, _, cf), = SC.ENGINES[4]
    SC.assert_engine_matches(ranks, tag, arch, cf, jax_serve)


def test_serve_step_on_2x2_is_the_unsharded_slab(ranks):
    """gpt2-tiny's cached prefill (``make_cached_prefill_step(cfg,
    rules)``) and two serve steps (``make_serve_step(cfg, rules)``) on
    (2, 2), caches from ``init_serve_caches(rules=)`` (each rank's two
    rows of the four): each call's logits the (batch rows, vocab
    columns) slab of the unsharded calls' at ``PREFILL_TOL``."""
    for r, out in enumerate(ranks):
        fails = str(out["serve|step|fail"])
        assert not fails, f"rank {r}:\n{fails}"
