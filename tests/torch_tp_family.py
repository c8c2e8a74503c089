"""Shared harness of the tensor-parallel family tests
(``test_torch_tp_moe.py``, ``test_torch_tp_mla.py``,
``test_torch_tp_whisper.py``, ``test_torch_tp_rwkv.py``,
``test_torch_tp_griffin.py``): one reduced float32 model of the reference
on gloo ranks on the CPU at (1, m) over (its last cohort axis, "model"),
against the reference's loss and ``jax.grad`` and against the stacked
round.

Each rank (``family_rank``, spawned by ``launch.ranks.run_ranks``, one
spawn a world size, one torch thread) runs, on its blocks of the
reference's own parameters (``convert.weights_to_rank``), the loss and its
backward, recording the expert picks of the forward
(``models.mlp.route``), and then ROUNDS distributed rounds a format from
the port's own placed init; it returns its local blocks and gradients,
and the parent gathers them (``full_leaves``).  The reference side
(``reference``) runs in the parent: ``jax.value_and_grad`` of its loss,
and its picks from a forward (``jax.lax.top_k``'s indices recorded),
layer by layer.
"""
import concurrent.futures
import functools
import math
import types

import numpy as np
import torch

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
from repro_torch.models import mlp as tmlp
from repro_torch.sharding import placement as tplace
from repro_torch.sharding import rules as trules
from test_torch_dist_round import _wire_bytes

TIMEOUT_S = 240.0
FORMATS = ("int", "rsag")
ROUNDS = 2
B, SEQ = 4, 16
RUN = ("model.dtype=float32", f"train.seq_len={SEQ}",
       f"train.global_batch={B}", "fl.local_iters=2", "fl.learning_rate=0.5",
       "channel.error_prob=0.0")
#: the reference's parameters' key and the port's init's seed
REF_KEY, SEED = 3, 0


def config(arch, extra=()):
    return apply_overrides(reduced(get_config(arch)), RUN + tuple(extra))


def batch(cfg, r):
    """Round r's batch (and the forward's, r = 0), from a numpy seed:
    tokens, labels and, for the encoder-decoder, frames."""
    rng = np.random.default_rng(300 + r)
    tok = rng.integers(0, cfg.model.vocab_size, (B, SEQ)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    if cfg.model.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, cfg.model.encoder_seq_len, cfg.model.d_model)
        ).astype(np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def family_rank(rank, world, init, arch, jobs):
    """Every job (shape, extra overrides, the reference's parameters) of
    one world size in one spawn: :func:`_job` on each."""
    torch.set_num_threads(1)
    comm_mod.init_process_group("gloo", rank, world, "cpu", init_method=init)
    try:
        return [_job(rank, arch, *job) for job in jobs]
    finally:
        comm_mod.destroy_process_group()


def _job(rank, arch, shape, extra, ref_params):
    cfg = config(arch, extra)
    mesh = mesh_of(shape, cfg)
    comm = comm_mod.Comm(mesh, cfg.fl.cohort_axes, "cpu")
    model = build_model(cfg)
    placed = tplace.place_model(model, cfg, comm)
    specs = trules.param_specs(model, cfg, mesh)
    out = {"D_local": placed.param_shapes.numel,
           "placed": placed is not model}
    # the forward and its gradient on the reference's parameters
    flat = convert.weights_to_rank(ref_params, specs, mesh, rank,
                                   device="cpu")
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(flat, placed.param_shapes).items()}
    route, picks = tmlp.route, []

    def recorded(logits, cfg_, capacity):
        res = route(logits, cfg_, capacity)
        picks.append(res[1].argmax(-1).reshape(-1).clone())
        return res

    tmlp.route = recorded
    try:
        loss, metrics = placed.loss(live, _torch_batch(batch(cfg, 0)))
        n_fwd = len(picks)
        loss.backward()
    finally:
        tmlp.route = route
    out["loss"] = float(loss.detach())
    out["metrics"] = {k: float(v.detach()) for k, v in metrics.items()}
    out["picks"] = picks[:n_fwd]
    out["grads"] = {k: v.grad.clone() for k, v in live.items()}
    # rounds from the port's placed init
    out["runs"] = {}
    for fmt in FORMATS:
        fn = make_dist_fl_round(model, cfg, comm, collective=fmt)
        params = comm.broadcast_(placed.init_flat(SEED, device="cpu"))
        gen = torch.Generator().manual_seed(7)
        hist = []
        for r in range(ROUNDS):
            before = dict(comm.sent)
            params, m = fn(params, _torch_batch(batch(cfg, r)), gen)
            hist.append({
                "params": convert.map_buffers(torch.clone, params),
                "loss": float(m["loss"]),
                "sent": {k: comm.sent[k] - before[k] for k in before},
                "bits": m["wire_bits_per_param"]})
        out["runs"][fmt] = hist
    return out


def run_meshes(tmp_path_factory, arch, meshes, refs):
    """``meshes`` (name -> (shape, extra)) on gloo ranks, one spawn a
    world size, the spawns at once; ``refs`` the :func:`reference` of each
    extra.  Returns name -> every rank's result."""
    spawns = {}
    for world in sorted({math.prod(s) for s, _ in meshes.values()}):
        names = [n for n, (s, _) in meshes.items() if math.prod(s) == world]
        jobs = [(meshes[n][0], tuple(meshes[n][1]),
                 refs[meshes[n][1]]["params"]) for n in names]
        spawns[world] = (names, functools.partial(
            run_ranks, family_rank, world, (arch, jobs),
            workdir=str(tmp_path_factory.mktemp(f"w{world}")),
            timeout_s=TIMEOUT_S))
    with concurrent.futures.ThreadPoolExecutor(len(spawns)) as pool:
        running = {w: pool.submit(run) for w, (_, run) in spawns.items()}
        out = {}
        for world, (names, _) in spawns.items():
            res = running[world].result()
            for j, n in enumerate(names):
                out[n] = [r[j] for r in res]
    return out


def reference(arch, extra=(), ulp_draws=0):
    """The reference's reduced model with ``extra``: its parameters (numpy
    leaves), its loss and metrics, ``jax.grad`` of its loss (by path) on
    round 0's batch, and its forward's expert picks, layer by layer
    (``jax.lax.top_k``'s indices recorded by ``jax.debug.callback``); with
    ``ulp_draws``, by path, the largest share of the leaf's largest
    gradient entry by which one float32 ulp on every parameter moves the
    leaf's gradient, over that many draws (``ulp_spread``).  JAX is
    imported here only: the spawned ranks import this module and need none
    of it."""
    import jax
    import jax.numpy as jnp
    from repro.config.base import apply_overrides as japply
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild

    jcfg = japply(jreduced(jget(arch)), RUN + tuple(extra))
    jmodel = jbuild(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(REF_KEY))
    b = {k: jnp.asarray(v) for k, v in batch(config(arch, extra), 0).items()}
    key = jax.random.PRNGKey(0)
    value_and_grad = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (loss, metrics), grads = value_and_grad(params, b, key)
    np_grads = convert.tree_paths(jax.tree_util.tree_map(np.asarray, grads))
    rng, spread = np.random.default_rng(11), dict.fromkeys(np_grads, 0.0)
    for _ in range(ulp_draws):
        moved = jax.tree_util.tree_map(lambda x: np.nextafter(
            np.asarray(x), np.where(rng.random(x.shape) < 0.5, -np.inf,
                                    np.inf).astype(x.dtype)), params)
        _, again = value_and_grad(moved, b, key)
        again = convert.tree_paths(jax.tree_util.tree_map(np.asarray, again))
        spread = {k: max(v, _share(again[k], np_grads[k]))
                  for k, v in spread.items()}
    picks = []
    if jcfg.model.moe.enabled:
        top_k = jax.lax.top_k

        def recorded(x, k):
            vals, idx = top_k(x, k)
            jax.debug.callback(
                lambda i: picks.append(np.asarray(i).reshape(-1)), idx)
            return vals, idx

        jax.lax.top_k = recorded
        try:        # without remat, which would run the layers twice
            jax.block_until_ready(jax.jit(functools.partial(
                jmodel.loss, remat=False))(params, b, key))
        finally:
            jax.lax.top_k = top_k
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return {"params": np_tree, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": np_grads, "picks": picks, "ulp_spread": spread}


def mesh_of(shape, cfg):
    """(cohorts, model) over the config's last cohort axis ("data", or
    deepseek's "pod") and "model"."""
    return tmesh.make_mesh(shape, (cfg.fl.cohort_axes[-1], "model"))


def specs_of(arch, extra, shape):
    cfg = config(arch, extra)
    model = build_model(cfg)
    return cfg, model, trules.param_specs(model, cfg, mesh_of(shape, cfg))


def full_leaves(locals_, layout, specs):
    """The whole leaves from every model rank's blocks (``locals_`` in
    model order, each a dict by path): concatenated along the dim the spec
    shards over "model", a replicated leaf rank 0's."""
    return {k: convert.gather_leaf([loc[k] for loc in locals_], specs[k])
            for k in layout}


def _share(got, want):
    """The largest difference as a share of the largest reference entry."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def near(got, want, rel, what):
    """Every entry within ``rel`` of the largest reference entry."""
    err = _share(got, want)
    assert err <= rel, f"{what}: {err:.3g} of the largest entry > {rel:g}"


# ---------------------------------------------------------------------------
# the checks each family file runs on its meshes
# ---------------------------------------------------------------------------

def check_forward(ranks, ref):
    """Every rank's loss and metrics within 1e-5 relative of the
    reference's (the aux loss and the multi-token term included)."""
    for o in ranks:
        assert o["placed"]
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=1e-5)
        assert set(o["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(o["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)


def whole_gradients(arch, extra, ref):
    """The port's own gradient of one process (no placement) on the
    reference's parameters and round 0's batch, by path."""
    cfg = config(arch, extra)
    model = build_model(cfg)
    live = {k: v.clone().requires_grad_(True) for k, v in
            convert.unflatten_params(convert.flat_from_tree(
                ref["params"], device="cpu"), model.param_shapes).items()}
    model.loss(live, _torch_batch(batch(cfg, 0)))[0].backward()
    return {k: v.grad.numpy() for k, v in live.items()}


def check_gradients(ranks, ref, arch, extra, shape, replicated, rel=1e-5,
                    ulps=0, whole=None):
    """Every leaf's gathered gradient within ``rel`` of its largest entry
    in ``jax.grad``'s, plus ``ulps`` times the share by which one float32
    ulp on every parameter moves the reference's own gradient of that leaf
    (``ref["ulp_spread"]``: an input on which float32 cannot resolve
    ``rel``, ROADMAP C10); with ``whole`` (:func:`whole_gradients`), also
    within ``rel`` of the port's gradient of one process (the split sums
    alone).  The leaves the rules replicate (``replicated``: names that
    must be among them) hold the whole gradient, ``torch.equal`` on every
    rank."""
    _, model, specs = specs_of(arch, extra, shape)
    rep = {k for k, s in specs.items() if trules.model_dim(s) is None}
    for name in replicated:
        hit = [k for k in rep if name in k.split("/")]
        assert hit, (name, sorted(rep))
    grads = full_leaves([o["grads"] for o in ranks], model.param_shapes,
                        specs)
    for k, g in grads.items():
        near(g.numpy(), ref["grads"][k], rel + ulps * ref["ulp_spread"][k],
             k)
        if whole is not None:
            near(g.numpy(), whole[k], rel, k)
        if k in rep:
            for o in ranks[1:]:
                assert torch.equal(o["grads"][k], ranks[0]["grads"][k]), k
    return grads


def check_picks(ranks, ref, flips=0):
    """Every routing of the forward picks the reference's experts: at most
    ``flips`` picks differ in all (0 on this data in float32)."""
    for o in ranks:
        assert len(o["picks"]) == len(ref["picks"]) > 0
        differ = sum(int((a.numpy() != b).sum())
                     for a, b in zip(o["picks"], ref["picks"]))
        assert differ <= flips, f"{differ} expert picks flip"
        for a, b in zip(o["picks"], ranks[0]["picks"]):
            assert torch.equal(a, b)


def check_placed_init(arch, extra, shape):
    """``LM.init_flat`` of the model placed on each rank of ``shape`` (a
    stand-in comm: the init reduces over nothing) is that rank's blocks of
    the whole model's init from the same seed, leaf by leaf, in bfloat16
    with the reference's float32 leaves (a buffer each)."""
    cfg, model, specs = specs_of(arch, tuple(extra) + ("model.dtype=bfloat16",),
                                 shape)
    assert set(model.param_shapes.buffer_dtypes) == {torch.bfloat16,
                                                     torch.float32}
    m = mesh_of(shape, cfg)
    whole = convert.unflatten_params(model.init_flat(SEED, device="cpu"),
                                     model.param_shapes)
    for rank in range(math.prod(shape)):
        comm = types.SimpleNamespace(mesh=m, model_size=shape[1], rank=rank)
        placed = tplace.place_model(model, cfg, comm)
        assert placed is not model
        blocks = convert.unflatten_params(placed.init_flat(SEED,
                                                           device="cpu"),
                                          placed.param_shapes)
        at = comm_mod.coords(m, rank)
        for k, leaf in whole.items():
            assert blocks[k].dtype == leaf.dtype, k
            assert torch.equal(blocks[k], convert.take_block(
                leaf, specs[k], m, at)), (rank, k)
    return specs


def check_rounds(ranks, arch, extra, shape):
    """After every round the replicated leaves are ``torch.equal`` across
    the model group and the rank's parameter bytes are
    ``bytes_per_device``; the gathered parameters are within ROADMAP C4's
    bound of the stacked round on the same draws (one uplink code step,
    99.9 % within 1e-5, the loss within rtol 1e-4); the wire bytes a rank
    sends are the plan's at D_local."""
    cfg, model, specs = specs_of(arch, extra, shape)
    m = mesh_of(shape, cfg)
    local = convert.local_layout(model.param_shapes, specs, m)
    rep = [k for k, s in specs.items() if trules.model_dim(s) is None]
    assert all(o["D_local"] == local.numel for o in ranks)
    assert local.numel * 4 == trules.bytes_per_device(model.param_shapes,
                                                      specs, m)
    C = shape[0]
    for fmt in FORMATS:
        plan = agg.make_wire_plan(fmt, cfg.quant, (cfg.fl.cohort_axes[-1],),
                                  (C,))
        for r, (params, loss, bits) in enumerate(
                stacked(arch, tuple(extra), C, fmt)):
            blocks = [convert.unflatten_params(o["runs"][fmt][r]["params"],
                                               local) for o in ranks]
            for k in rep:
                for b in blocks[1:]:
                    assert torch.equal(b[k], blocks[0][k]), (fmt, r, k)
            whole = full_leaves(blocks, model.param_shapes, specs)
            full = torch.cat([whole[k].reshape(-1)
                              for k in model.param_shapes])
            diff = (full - params).abs()
            assert float(diff.max()) <= 1 / 128 + 1e-7, (fmt, r, diff.max())
            assert float((diff <= 1e-5).float().mean()) >= 0.999, (fmt, r)
            got = ranks[0]["runs"][fmt][r]
            np.testing.assert_allclose(got["loss"], loss, rtol=1e-4,
                                       err_msg=fmt)
            assert got["bits"] == bits
            for o in ranks:
                run_ = o["runs"][fmt][r]
                assert run_["loss"] == got["loss"]
                # the loss's and the survivors' float32 psums aside
                wire = run_["sent"]["psum"] + run_["sent"]["hop"] - 8
                assert wire == _wire_bytes(plan, o["D_local"]), (fmt, wire)
                assert run_["sent"]["model"] > 0


@functools.lru_cache(maxsize=None)
def stacked(arch, extra, C, fmt):
    """The stacked round's ROUNDS rounds from the port's init on the draws
    the distributed round makes (``fl.dist_round_noise``): (parameters,
    loss, wire bits a parameter) a round, the same for every mesh of C
    cohorts."""
    cfg = config(arch, extra)
    model = build_model(cfg)
    fn = make_fl_round(model, cfg, (C,), collective=fmt, device="cpu")
    params = model.init_flat(SEED, device="cpu")
    gen = torch.Generator().manual_seed(7)
    out = []
    for r in range(ROUNDS):
        params, mt = fn(params, _torch_batch(batch(cfg, r)),
                        noise=dist_round_noise(model, cfg, gen, C,
                                               model.param_shapes.numel))
        out.append((params, float(mt["loss"]), mt["wire_bits_per_param"]))
    return out
