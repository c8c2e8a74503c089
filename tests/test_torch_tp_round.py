"""The distributed cohort round with tensor parallelism over the mesh's
"model" axis (``sharding.placement``, the tensor-parallel dense forward,
``core.comm``'s model group) on gloo ranks on the CPU, against the
stacked round and the reference.

Reduced qwen2.5-14b in float32 with 2 kv heads (its q/k/v biases
present): at (1, 4) over ("data", "model") its query heads, ff columns
and vocabulary shard and its kv heads replicate (GQA at mixed
divisibility: rank m's one query head reads kv head m // 2 of the
replicated wk/wv); at (1, 3) nothing divides and everything replicates.
One spawn a mesh runs every format (int, packed, ring, rsag), 2 rounds
each from one generator.  Checks:

* every block equals ``convert.take_block`` of the leaf gathered over the
  model group (``Comm.model_gather``), and the replicated leaves are
  ``torch.equal`` across the model group after every round;
* the gathered parameters within ROADMAP C4's bound of the stacked round
  on the same draws (``fl.dist_round_noise``): one uplink code step,
  99.9 % within 1e-5, the loss within rtol 1e-4;
* the wire bytes a rank sends, the plan's at D_local (exactly, as
  ``tests/test_torch_dist_round.py`` prices them);
* the forward alone (``LM.loss`` on each rank's blocks of the reference's
  own parameters, ``convert.weights_to_rank``) within 1e-5 of the
  reference's ``loss``, also with its own 4 kv heads, which shard at
  (1, 4) with their biases' blocks;
* in bfloat16 with float32 norms (two buffers), the placed init's blocks
  gathered leaf by leaf into the checkpoint rank 0 writes: the file a
  single process writes of the whole init, which every rank restores
  into its own blocks;
* the named ``NotImplementedError`` for reduced granite (MoE) at (1, 2),
  and for ``train.zero_over_model``.
"""
import functools
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core.fl import (dist_round_noise, make_dist_fl_round,
                                 make_fl_round)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build_model
from repro_torch.sharding import placement as tplace
from repro_torch.sharding import rules as trules
from test_torch_dist_round import _wire_bytes

TIMEOUT_S = 120.0
FORMATS = ("int", "packed", "ring", "rsag")
ROUNDS = 2
B, SEQ = 4, 16
QWEN = ("model.n_kv_heads=2", "model.dtype=float32", f"train.seq_len={SEQ}",
        f"train.global_batch={B}", "fl.local_iters=2",
        "fl.learning_rate=0.5", "channel.error_prob=0.0")
#: the forward alone also at reduced qwen's own kv heads (4)
KV = {"kv2": QWEN, "kv4": QWEN[1:]}
MESHES = {"1x4": (1, 4), "1x3": (1, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(overrides=QWEN):
    return apply_overrides(reduced(get_config("qwen2.5-14b")), overrides)


def _batch(r):
    rng = np.random.default_rng(200 + r)
    tok = torch.from_numpy(rng.integers(0, 512, (B, SEQ)).astype(np.int32))
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def _checkpoint(comm, ckpt_dir):
    """Rank 0 saves the bfloat16 model's placed init, gathered a leaf at a
    time (the others take part); every rank restores its blocks."""
    cfg = apply_overrides(reduced(get_config("qwen2.5-14b")),
                          ("model.n_kv_heads=2",))
    placed = tplace.place_model(build_model(cfg), cfg, comm)
    params = placed.init_flat(3, device="cpu")
    gather = functools.partial(tplace.gather_block, placed)
    if comm.rank == 0:
        ckpt.save_params(ckpt_dir, 1, params, placed.param_shapes,
                         gather=gather)
    else:
        for _ in ckpt.param_leaves(params, placed.param_shapes, gather):
            pass
    comm.barrier()
    back = ckpt.restore_params(ckpt_dir, placed.init_flat(4, device="cpu"),
                               placed.param_shapes,
                               placement=placed.placement)
    return [(torch.equal(a, b), a.dtype) for a, b in
            zip(convert.buffers(back), convert.buffers(params))]


def _tp_rank(rank, world, init, shape, ref_params, ckpt_dir):
    torch.set_num_threads(1)
    comm_mod.init_process_group("gloo", rank, world, "cpu", init_method=init)
    try:
        mesh = tmesh.make_mesh(shape, ("data", "model"))
        comm = comm_mod.Comm(mesh, ("pod", "data"), "cpu")
        cfg = _cfg()
        model = build_model(cfg)
        placed = tplace.place_model(model, cfg, comm)
        out = {"D_local": placed.param_shapes.numel, "runs": {},
               "sharded": placed is not model}
        for fmt in FORMATS:
            fn = make_dist_fl_round(model, cfg, comm, collective=fmt)
            params = comm.broadcast_(placed.init_flat(cfg.fl.seed,
                                                      device="cpu"))
            gen = torch.Generator().manual_seed(7)
            hist = []
            for r in range(ROUNDS):
                before = dict(comm.sent)
                params, m = fn(params, _batch(r), gen)
                sent = {k: comm.sent[k] - before[k] for k in before}
                leaves = convert.unflatten_params(params, placed.param_shapes)
                gathered = {k: torch.cat([b.reshape(-1) for b in
                                          comm.model_gather(v.contiguous())])
                            for k, v in leaves.items()}
                hist.append({"params": params.clone(), "gathered": gathered,
                             "loss": float(m["loss"]), "sent": sent,
                             "bits": m["wire_bits_per_param"]})
            out["runs"][fmt] = hist
        # the forward alone on the reference's own parameters
        out["ref_loss"] = {}
        for kv, overrides in KV.items():
            cfg = _cfg(overrides)
            model = build_model(cfg)
            placed = tplace.place_model(model, cfg, comm)
            specs = trules.param_specs(model, cfg, mesh)
            flat = convert.weights_to_rank(ref_params[kv], specs, mesh, rank,
                                           device="cpu")
            loss, _ = placed.loss(convert.unflatten_params(
                flat, placed.param_shapes), _batch(0))
            out["ref_loss"][kv] = float(loss)
        out["checkpoint"] = _checkpoint(comm, ckpt_dir)
        return out
    finally:
        comm_mod.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced qwen, its parameters and its loss on
    round 0's batch (JAX imported here only: the spawned ranks import this
    module and need none of it)."""
    import jax
    from repro.config.base import apply_overrides as japply
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild

    params, losses = {}, {}
    batch = {k: np.asarray(v) for k, v in _batch(0).items()}
    for kv, overrides in KV.items():
        jmodel = jbuild(japply(jreduced(jget("qwen2.5-14b")), overrides))
        p = jmodel.init(jax.random.PRNGKey(3))
        loss, _ = jax.jit(jmodel.loss)(p, batch, jax.random.PRNGKey(0))
        params[kv] = jax.tree_util.tree_map(np.asarray, p)
        losses[kv] = float(loss)
    return params, losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    out = {}
    for name, shape in MESHES.items():
        work = tmp_path_factory.mktemp(name)
        out[name] = run_ranks(_tp_rank, math.prod(shape),
                              (shape, reference[0], str(work / "ckpt")),
                              workdir=str(work / "ranks"),
                              timeout_s=4 * TIMEOUT_S)
        out[name + "/ckpt"] = str(work / "ckpt")
    return out


def _leaf_blocks(flat, layout):
    return convert.unflatten_params(flat, layout)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_blocks_and_replicated_leaves(ranks, mesh):
    out = ranks[mesh]
    shape = MESHES[mesh]
    m = tmesh.make_mesh(shape, ("data", "model"))
    cfg = _cfg()
    model = build_model(cfg)
    specs = trules.param_specs(model, cfg, m)
    local = convert.local_layout(model.param_shapes, specs, m)
    sharded = [k for k, s in specs.items() if trules.model_dim(s) is not None]
    if mesh == "1x4":
        assert all(o["sharded"] for o in out)
        assert {"blocks/attn/wq", "blocks/attn/wo", "blocks/mlp/w_up",
                "embed", "head"} <= set(sharded)
        assert "blocks/attn/wk" not in sharded
        assert "blocks/attn/bq" not in sharded
    else:
        assert not sharded and not any(o["sharded"] for o in out)
    assert all(o["D_local"] == local.numel for o in out)
    # each rank's parameter bytes: the reference's bytes_per_device
    assert local.numel * 4 == trules.bytes_per_device(model.param_shapes,
                                                      specs, m)
    for fmt in FORMATS:
        for r in range(ROUNDS):
            gathered = out[0]["runs"][fmt][r]["gathered"]
            for o in out[1:]:
                for k in gathered:
                    assert torch.equal(o["runs"][fmt][r]["gathered"][k],
                                       gathered[k]), (fmt, r, k)
            for rank, o in enumerate(out):
                at = comm_mod.coords(m, rank)
                blocks = _leaf_blocks(o["runs"][fmt][r]["params"], local)
                for k, shape_k in model.param_shapes.items():
                    full = _full_leaf(gathered[k], shape_k, specs[k], m)
                    assert torch.equal(blocks[k], convert.take_block(
                        full, specs[k], m, at)), (fmt, r, k, rank)
                    if k not in sharded:
                        assert torch.equal(blocks[k], _leaf_blocks(
                            out[0]["runs"][fmt][r]["params"], local)[k])


def _full_leaf(flat_blocks, shape, spec, mesh):
    """A leaf from the concatenation of its model ranks' flattened blocks
    (``Comm.model_gather`` in model order)."""
    d = trules.model_dim(spec)
    if d is None:
        n = math.prod(shape)
        return flat_blocks[:n].reshape(shape)
    block = list(shape)
    block[d] //= mesh["model"]
    parts = flat_blocks.reshape(mesh["model"], *block).unbind(0)
    return convert.gather_leaf(parts, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_round_within_c4_of_the_stacked_round(ranks, mesh):
    out = ranks[mesh]
    shape = MESHES[mesh]
    m = tmesh.make_mesh(shape, ("data", "model"))
    cfg = _cfg()
    model = build_model(cfg)
    specs = trules.param_specs(model, cfg, m)
    D = model.param_shapes.numel
    C = shape[0]
    for fmt in FORMATS:
        fn = make_fl_round(model, cfg, (C,), collective=fmt, device="cpu")
        params = model.init_flat(cfg.fl.seed, device="cpu")
        gen = torch.Generator().manual_seed(7)
        plan = agg.make_wire_plan(fmt, cfg.quant, ("data",), (C,))
        for r in range(ROUNDS):
            params, mt = fn(params, _batch(r),
                            noise=dist_round_noise(model, cfg, gen, C, D))
            got = out[0]["runs"][fmt][r]
            full = torch.cat([_full_leaf(got["gathered"][k], s, specs[k],
                                         m).reshape(-1)
                              for k, s in model.param_shapes.items()])
            diff = (full - params).abs()
            assert float(diff.max()) <= 1 / 128 + 1e-7, (fmt, r, diff.max())
            assert float((diff <= 1e-5).float().mean()) >= 0.999, (fmt, r)
            np.testing.assert_allclose(got["loss"], float(mt["loss"]),
                                       rtol=1e-4, err_msg=fmt)
            assert got["bits"] == mt["wire_bits_per_param"]
            for o in out:
                run = o["runs"][fmt][r]
                assert run["loss"] == got["loss"]
                # the loss's and the survivors' float32 psums aside
                wire = run["sent"]["psum"] + run["sent"]["hop"] - 8
                assert wire == _wire_bytes(plan, o["D_local"]), (fmt, wire)
                assert (run["sent"]["model"] > 0) == (mesh == "1x4")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_the_reference_loss(ranks, reference, mesh):
    for o in ranks[mesh]:
        for kv, loss in reference[1].items():
            np.testing.assert_allclose(o["ref_loss"][kv], loss, rtol=1e-5,
                                       err_msg=kv)
    cfg = _cfg(KV["kv4"])
    specs = trules.param_specs(build_model(cfg), cfg, tmesh.make_mesh(
        MESHES[mesh], ("data", "model")))
    assert (trules.model_dim(specs["blocks/attn/wk"]) is not None) == (
        mesh == "1x4")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_checkpoint_of_blocks_is_the_whole_tree(ranks, mesh):
    """The file rank 0 wrote from the gathered blocks is a single
    process's checkpoint of the whole seed-3 init (both buffers), and every
    rank restored its own blocks from it."""
    for o in ranks[mesh]:
        assert [d for _, d in o["checkpoint"]] == [torch.bfloat16,
                                                  torch.float32]
        assert all(ok for ok, _ in o["checkpoint"])
    cfg = apply_overrides(reduced(get_config("qwen2.5-14b")),
                          ("model.n_kv_heads=2",))
    model = build_model(cfg)
    whole = ckpt.restore_params(ranks[mesh + "/ckpt"],
                                model.init_flat(5, device="cpu"),
                                model.param_shapes)
    for a, b in zip(convert.buffers(whole),
                    convert.buffers(model.init_flat(3, device="cpu"))):
        assert torch.equal(a, b)


def _fake_comm(shape):
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    return types.SimpleNamespace(mesh=mesh, model_size=shape[1], rank=0,
                                 axes=("data",), axis_sizes=(shape[0],),
                                 num_cohorts=shape[0], cohort=0)


def test_unported_families_and_zero_over_model_raise():
    granite = reduced(get_config("granite-moe-1b-a400m"))
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        make_dist_fl_round(build_model(granite), granite, _fake_comm((1, 2)))
    zero = apply_overrides(_cfg(), ("train.zero_over_model=true",))
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        make_dist_fl_round(build_model(zero), zero, _fake_comm((1, 4)))
    # one model rank: nothing is placed, every family runs
    assert tplace.place_model(build_model(granite), granite,
                              _fake_comm((2, 1))).placement is None
