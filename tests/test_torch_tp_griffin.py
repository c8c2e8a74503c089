"""The Griffin hybrid tensor-parallel over the mesh's "model" axis in the
distributed cohort round (``models.griffin.recurrent_block`` under
``tp``, beside the local attention and MLP), on gloo ranks on the CPU
against the reference (``tests/torch_tp_family.py``).

Reduced recurrentgemma-2b in float32 at 3 layers (recurrent, recurrent,
attention; d_model and d_rnn 256, 4 heads with 1 kv head, ff 512,
vocabulary 512, window 16) at (1, 2) and (1, 4): ``w_x``, ``w_gate``,
``w_a`` and ``w_i`` shard their columns and ``w_out`` its rows (``w_a``
and ``w_i`` read the post-conv u that ``w_x`` split: u is gathered and
taken through f); ``conv_w``, ``conv_b``, ``b_a``, ``b_i``, ``lam`` and
the norms replicate; the attention's wq and wo shard and the single kv
head's wk and wv replicate.  With ``model.n_heads=2`` at (1, 4) the
whole attention replicates, as recurrentgemma-2b's 10 heads do at
(1, 4): it runs with no f or g, its gradients equal on every rank.
Checks: the loss within 1e-5 relative of the reference's; every leaf's
gathered gradient within 1e-5 of its largest entry in ``jax.grad``'s,
the replicated leaves' ``torch.equal`` on every rank; the placed init's
blocks; 2 rounds in int and rsag within ROADMAP C4's bound of the
stacked round on the same draws, with the wire bytes a rank the plan's at
D_local.
"""
import pytest
import torch

import torch_tp_family as fam
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.sharding import rules as trules

ARCH = "recurrentgemma-2b"
THREE = ("model.n_layers=3",)
MESHES = {"1x2": ((1, 2), THREE), "1x4": ((1, 4), THREE),
          "1x4-h2": ((1, 4), THREE + ("model.n_heads=2",))}
REPLICATED = ("conv_w", "conv_b", "b_a", "b_i", "lam", "norm1", "norm2",
              "final_norm", "wk", "wv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    return {extra: fam.reference(ARCH, extra)
            for extra in {e for _, e in MESHES.values()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, refs):
    return fam.run_meshes(tmp_path_factory, ARCH, MESHES, refs)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placement_of_the_recurrent_block(mesh):
    shape, extra = MESHES[mesh]
    specs = fam.check_placed_init(ARCH, extra, shape)
    for i in (0, 1):
        for k in ("w_x", "w_gate", "w_a", "w_i"):
            assert specs[f"blocks/{i}/rec/{k}"] == (None, "model"), k
        assert specs[f"blocks/{i}/rec/w_out"] == ("model", None)
        for k in REPLICATED[:5]:
            assert trules.model_dim(specs[f"blocks/{i}/rec/{k}"]) is None
    heads = "h2" not in mesh
    assert specs["blocks/2/attn/wq"] == ((None, "model") if heads
                                         else (None, None))
    assert specs["blocks/2/attn/wk"] == (None, None)
    assert specs["blocks/2/mlp/w_up"] == (None, "model")
    # recurrentgemma-2b itself: its 10 heads shard at (1, 2), not at (1, 4)
    cfg = get_config(ARCH)
    full = trules.param_specs(build_model(cfg), cfg,
                              tmesh.make_mesh(shape, ("data", "model")))
    assert full["blocks/2/attn/wq"] == ((None, "model") if shape[1] == 2
                                        else (None, None))
    assert full["blocks/0/rec/w_a"] == (None, "model")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, refs, mesh):
    fam.check_forward(ranks[mesh], refs[MESHES[mesh][1]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax_grad(ranks, refs, mesh):
    shape, extra = MESHES[mesh]
    grads = fam.check_gradients(ranks[mesh], refs[extra], ARCH, extra, shape,
                                REPLICATED)
    for k in ("0/rec/w_a", "1/rec/lam", "1/rec/conv_w", "2/attn/wk",
              "2/attn/wq"):
        assert float(grads[f"blocks/{k}"].abs().max()) > 0, k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rounds_within_c4_of_the_stacked_round(ranks, mesh):
    shape, extra = MESHES[mesh]
    fam.check_rounds(ranks[mesh], ARCH, extra, shape)
