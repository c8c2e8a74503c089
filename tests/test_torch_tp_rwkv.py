"""RWKV-6 tensor-parallel over the mesh's "model" axis in the distributed
cohort round (``models.rwkv`` under ``tp``), on gloo ranks on the CPU
against the reference (``tests/torch_tp_family.py``).

Reduced rwkv6-7b in float32 (2 layers, d_model 256, 4 heads of 64, ff
512, vocabulary 512) at (1, 2) and (1, 4): ``w_r``/``w_k``/``w_v``/
``w_g``, ``cm_wk``, ``ddlerp_A`` and ``decay_A`` shard their columns,
``w_o``, ``cm_wv``, ``cm_wr``, ``decay_B`` and ``ddlerp_B`` their rows
(``ddlerp_A``'s flat 160 columns against ``ddlerp_B``'s 32 rows of every
mix: they do not line up), the vocabulary too; ``mu_base``,
``decay_base``, ``bonus_u``, ``ln_x_scale``, ``cm_mu_k``, ``cm_mu_r``
and the norms replicate.  With ``model.n_heads=2`` at (1, 4) each head
of 128 channels lies on two ranks (the split head: r, k and v gathered,
every head on every rank).  The rounds at lr 0.01 (ROADMAP C7: at 0.5
the first local step moves ``bonus_u`` by up to ~114 and two float32
orders part).  Checks: the loss within 1e-5 relative of the reference's;
every leaf's gathered gradient against ``jax.grad``'s within 1e-4 of
the leaf's largest entry plus twice the share by which one float32 ulp
on every parameter moves the reference's own gradient of that leaf (the
largest over 8 draws): on this input that ulp moves it past 1e-4 of a
leaf's largest entry (up to 2.2e-4 at 4 heads and 8.4e-4 at 2), so no
float32 order of these sums resolves 1e-4 alone (ROADMAP C7, C10); and
within 1e-4 of the port's own gradient of one process on the same
parameters (the split sums alone); the replicated leaves'
``torch.equal`` on every rank; the placed init's blocks; 2 rounds in int
and rsag within ROADMAP C4's bound of the stacked round on the same
draws, with the wire bytes a rank the plan's at D_local.
"""
import pytest
import torch

import torch_tp_family as fam
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.sharding import rules as trules

ARCH = "rwkv6-7b"
LR = ("fl.learning_rate=0.01",)
#: draws of one float32 ulp on every parameter of the reference
ULP_DRAWS = 8
#: (mesh over ("data", "model"), extra overrides)
MESHES = {"1x2": ((1, 2), LR), "1x4": ((1, 4), LR),
          "1x4-h2": ((1, 4), LR + ("model.n_heads=2",))}
REPLICATED = ("mu_base", "decay_base", "bonus_u", "ln_x_scale", "cm_mu_k",
              "cm_mu_r", "norm1", "norm2", "final_norm")
COLUMNS = ("w_r", "w_k", "w_v", "w_g", "cm_wk", "ddlerp_A", "decay_A")
ROWS = ("w_o", "cm_wv", "cm_wr", "decay_B")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    return {extra: fam.reference(ARCH, extra, ulp_draws=ULP_DRAWS)
            for extra in {e for _, e in MESHES.values()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, refs):
    return fam.run_meshes(tmp_path_factory, ARCH, MESHES, refs)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placement_of_the_time_and_channel_mix(mesh):
    shape, extra = MESHES[mesh]
    specs = fam.check_placed_init(ARCH, extra, shape)
    for k in COLUMNS:
        assert specs[f"blocks/rwkv/{k}"] == (None, None, "model"), k
    for k in ROWS:
        assert specs[f"blocks/rwkv/{k}"] == (None, "model", None), k
    assert specs["blocks/rwkv/ddlerp_B"] == (None, None, "model", None)
    for k in REPLICATED[:6]:
        assert trules.model_dim(specs[f"blocks/rwkv/{k}"]) is None, k
    # rwkv6-7b itself: the same leaves split at full width
    cfg = get_config(ARCH)
    full = trules.param_specs(build_model(cfg), cfg,
                              tmesh.make_mesh(shape, ("data", "model")))
    assert all(full[k] == specs[k] for k in specs)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, refs, mesh):
    fam.check_forward(ranks[mesh], refs[MESHES[mesh][1]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax_grad(ranks, refs, mesh):
    shape, extra = MESHES[mesh]
    # the premise of the bound: on this input one float32 ulp on the
    # parameters moves the reference's own gradient past 1e-4
    spread = refs[extra]["ulp_spread"]
    assert max(spread.values()) > 1e-4, spread
    grads = fam.check_gradients(ranks[mesh], refs[extra], ARCH, extra, shape,
                                REPLICATED, rel=1e-4, ulps=2,
                                whole=fam.whole_gradients(ARCH, extra,
                                                          refs[extra]))
    for k in ("ddlerp_A", "ddlerp_B", "decay_B", "bonus_u", "mu_base"):
        assert float(grads[f"blocks/rwkv/{k}"].abs().max()) > 0, k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rounds_within_c4_of_the_stacked_round(ranks, mesh):
    shape, extra = MESHES[mesh]
    fam.check_rounds(ranks[mesh], ARCH, extra, shape)
