"""whisper-base tensor-parallel over the mesh's "model" axis in the
distributed cohort round: the encoder's and the decoder's self-attention
and MLPs on the rank's heads and ff columns, the cross-attention on its
heads with the encoder's states through f at each decoder layer's cross
k and v, and the vocabulary's blocks (``models.whisper``), on gloo ranks
on the CPU against the reference (``tests/torch_tp_family.py``).

Reduced whisper in float32 (2 + 2 layers, d_model 256, 4 heads, ff 512,
vocabulary 512, 64 frames) at (1, 2) and (1, 4): every attention and MLP
shards, and so do its embedding and head (512 divides; whisper-base's
51,865 does not, and stays whole); the norms replicate.  Batches carry
frames from a numpy seed.  Checks: the cross-entropy within 1e-5
relative of the reference's; every leaf's gathered gradient within 1e-5
of its largest entry in ``jax.grad``'s, the encoder's (which takes its
gradient through every decoder layer's cross k and v) and the norms
named; 2 rounds in int and rsag within ROADMAP C4's bound of the stacked
round on the same draws, the replicated leaves ``torch.equal`` across the
model group after every round, the wire bytes a rank the plan's at
D_local.
"""
import pytest
import torch

import torch_tp_family as fam
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.sharding import rules as trules

ARCH = "whisper-base"
MESHES = {"1x2": ((1, 2), ()), "1x4": ((1, 4), ())}
REPLICATED = ("enc_norm", "final_norm", "norm1", "norm2", "norm_x")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    return {(): fam.reference(ARCH)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, refs):
    return fam.run_meshes(tmp_path_factory, ARCH, MESHES, refs)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placement_of_both_stacks(mesh):
    _, model, specs = fam.specs_of(ARCH, (), MESHES[mesh][0])
    for pre in ("enc/attn", "dec/self_attn", "dec/cross_attn"):
        for k in ("wq", "wk", "wv"):
            assert specs[f"{pre}/{k}"] == (None, None, "model")
        assert specs[f"{pre}/wo"] == (None, "model", None)
    assert specs["head"] == (None, "model")
    # whisper-base's own vocabulary divides neither 2 nor 4
    cfg = get_config(ARCH)
    full = trules.param_specs(build_model(cfg), cfg, tmesh.make_mesh(
        MESHES[mesh][0], ("data", "model")))
    assert full["head"] == (None, None) and full["embed"] == (None, None)
    assert full["enc/attn/wq"] == (None, None, "model")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, refs, mesh):
    fam.check_forward(ranks[mesh], refs[()])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax_grad(ranks, refs, mesh):
    grads = fam.check_gradients(ranks[mesh], refs[()], ARCH, (),
                                MESHES[mesh][0], REPLICATED)
    for k in ("enc/attn/wq", "enc/mlp/w_up", "enc_norm/scale",
              "dec/cross_attn/wk"):
        assert float(grads[k].abs().max()) > 0, k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rounds_within_c4_of_the_stacked_round(ranks, mesh):
    fam.check_rounds(ranks[mesh], ARCH, (), MESHES[mesh][0])
