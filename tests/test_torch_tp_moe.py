"""The MoE tensor-parallel over the mesh's "model" axis in the
distributed cohort round (``mlp.moe`` expert-parallel, or on the experts'
ff columns), on gloo ranks on the CPU against the reference
(``tests/torch_tp_family.py``).

Reduced granite-moe-1b-a400m in float32 (2 layers, d_model 256, 4 heads,
4 experts top-2, expert ff 128, vocabulary 512): at (1, 2) and (1, 4) its
experts shard on the expert dim (2 and 1 a rank), its heads, vocabulary
and head too, its router and norms replicate; with 6 experts at (1, 4)
the expert dim does not divide, and the experts shard on their ff
columns (``w_gate``/``w_up`` on the last dim, ``w_down`` on its ff dim)
while attention shards as before.  One spawn a mesh.  Checks, on each
rank's blocks of the reference's own parameters
(``convert.weights_to_rank``): the loss with its aux term within 1e-5
relative of the reference's; every leaf's gathered gradient within 1e-5
of its largest entry in ``jax.grad``'s, the router and the norms whole
and ``torch.equal`` on every rank; no expert pick flips against the
reference's forward (float32, this data: the bound is 0).  Then 2 rounds
in int and rsag: the replicated leaves ``torch.equal`` across
the model group after every round, the gathered parameters within ROADMAP
C4's bound of the stacked round on the same draws, and the wire bytes a
rank the plan's at D_local.  The two meshes of 4 ranks share a spawn.
"""
import pytest
import torch

import torch_tp_family as fam

ARCH = "granite-moe-1b-a400m"
#: (mesh over ("data", "model"), extra overrides)
MESHES = {"1x2": ((1, 2), ()), "1x4": ((1, 4), ()),
          "1x4-e6": ((1, 4), ("model.moe.num_experts=6",))}
REPLICATED = ("router", "norm1", "norm2", "final_norm")


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
def test_placement_of_the_experts(mesh):
    shape, extra = MESHES[mesh]
    _, model, specs = fam.specs_of(ARCH, extra, shape)
    if extra:
        assert specs["blocks/moe/w_gate"] == (None, None, None, "model")
        assert specs["blocks/moe/w_up"] == (None, None, None, "model")
        assert specs["blocks/moe/w_down"] == (None, None, "model", None)
    else:
        for k in ("w_gate", "w_up", "w_down"):
            assert specs[f"blocks/moe/{k}"] == (None, "model", None, None)
    assert specs["blocks/moe/router"] == (None, None, None)
    assert specs["blocks/attn/wq"][-1] == "model"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, refs, mesh):
    fam.check_forward(ranks[mesh], refs[MESHES[mesh][1]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax_grad(ranks, refs, mesh):
    shape, extra = MESHES[mesh]
    grads = fam.check_gradients(ranks[mesh], refs[extra], ARCH, extra, shape,
                                REPLICATED)
    assert float(grads["blocks/moe/router"].abs().max()) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_picks_match_the_reference(ranks, refs, mesh):
    fam.check_picks(ranks[mesh], refs[MESHES[mesh][1]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rounds_within_c4_of_the_stacked_round(ranks, mesh):
    shape, extra = MESHES[mesh]
    fam.check_rounds(ranks[mesh], ARCH, extra, shape)
