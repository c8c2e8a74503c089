"""deepseek-v3-671b tensor-parallel over the mesh's "model" axis in the
distributed cohort round: MLA on the rank's heads (``mla.mla_attention``),
the routed experts expert-parallel, the shared expert and the
multi-token block (``mlp.moe``, ``LM._mtp_ce``), on gloo ranks on the CPU
against the reference (``tests/torch_tp_family.py``).

Reduced deepseek in float32 (2 layers, d_model 256, 4 heads, 4 experts
top-2 beside 1 shared, MLA ranks 32 and 48, one multi-token block).  At
(1, 2) and (1, 4) MLA's ``w_uq``/``w_uk``/``w_uv`` are column-parallel and
``wo`` row-parallel, ``w_dq``, ``w_dkv``, ``q_norm``, ``kv_norm``, the
router and ``mtp/proj`` replicate.  At (1, 2) the reference's rule takes
the layer dim of the stacked shared expert (2, d, ff) for its expert dim,
so rank m holds layer m's shared expert, gathered whole before use; at
(1, 4) it shards on its ff dim.  The multi-token block's shared expert
shards ``w_down`` on its output dim, and is gathered whole.  Checks as
``tests/test_torch_tp_moe.py``'s: the loss with its aux and MTP terms,
every leaf's gathered gradient within 1e-5 of its largest entry in
``jax.grad``'s (the replicated low-rank path named one by one), no expert
pick flips (the bound: 0), and 2 rounds in int and rsag against the
stacked round within ROADMAP C4's bound, the replicated leaves
``torch.equal`` across the model group after every round, the wire bytes
a rank the plan's at D_local.
"""
import pytest
import torch

import torch_tp_family as fam

ARCH = "deepseek-v3-671b"
MESHES = {"1x2": ((1, 2), ()), "1x4": ((1, 4), ())}
REPLICATED = ("router", "w_dq", "w_dkv", "q_norm", "kv_norm", "proj",
              "norm1", "norm2", "final_norm")


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
def test_placement_of_mla_and_the_shared_expert(mesh):
    shape, extra = MESHES[mesh]
    _, model, specs = fam.specs_of(ARCH, extra, shape)
    for k in ("w_uq", "w_uk", "w_uv"):
        assert specs[f"blocks/mla/{k}"] == (None, None, "model")
    assert specs["blocks/mla/wo"] == (None, "model", None)
    shared = specs["blocks/moe/shared/w_gate"]
    assert shared == (("model", None, None) if shape[1] == 2
                      else (None, None, "model"))
    assert specs["mtp/block/moe/shared/w_down"] == (None, "model")
    assert specs["mtp/proj"] == (None, None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, refs, mesh):
    fam.check_forward(ranks[mesh], refs[()])
    assert set(refs[()]["metrics"]) == {"ce", "aux", "mtp_ce"}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax_grad(ranks, refs, mesh):
    grads = fam.check_gradients(ranks[mesh], refs[()], ARCH, (),
                                MESHES[mesh][0], REPLICATED)
    for k in ("mtp/block/mla/w_uq", "blocks/moe/shared/w_down",
              "mtp/block/moe/shared/w_down", "blocks/mla/w_dkv"):
        assert float(grads[k].abs().max()) > 0, k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_picks_match_the_reference(ranks, refs, mesh):
    fam.check_picks(ranks[mesh], refs[()])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rounds_within_c4_of_the_stacked_round(ranks, mesh):
    fam.check_rounds(ranks[mesh], ARCH, (), MESHES[mesh][0])
