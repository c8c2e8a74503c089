"""The distributed cohort round: one cohort a process over
``torch.distributed`` (gloo on the CPU), against the stacked round and the
reference.

Ranks run as subprocesses (``launch.ranks.run_ranks``, the ``spawn``
start method), each group on a ``FileStore`` under ``tmp_path``, one torch
thread a rank and a timeout on every wait.  The cases:

* the wire (``aggregation.aggregate_rank`` over ``core.comm.Comm``) at
  (2,), (4,), (3,), (2, 2) and (2, 2, 2) over the cohort axes, in every
  format at 8 bits (the int16 container) and 4 bits (int8), int also at
  16 (int32), ``pipeline_hops`` on and off, with every other cohort dropped
  and with every cohort dropped, and packed at a lane of 16 with codes
  near the clip, so the word sum carries into bit 31: ``torch.equal`` to
  the stacked ``aggregate`` on the same rows (paper within rtol 1e-6 of
  the largest value: its float sum runs in the backend's order), on every
  rank, and the bytes each rank hands the transport those the plan's
  ``wire_bits_per_param`` prices (exactly, with each message's padding);
* reduced olmo-1b on 8 ranks at (2, 4) over ("data", "model") and at
  (2, 2, 2) over ("pod", "data", "model"), 2 rounds a format from one
  generator.  Its heads, ff columns and (tied) vocabulary divide the model
  axis (4 and 2), so the rounds run tensor-parallel
  (``sharding.placement``): after every round the parameters gathered
  over the model group are ``torch.equal`` on every rank, each rank's
  blocks are ``torch.equal`` on the ranks of its model index and its
  replicated leaves on every rank; the quantized formats ``torch.equal``
  to each other; a fleet round whose model ranks read the same λ (equal
  fleets on every rank, and the stacked fleet round's result); and the
  stacked round on the same draws (``fl.dist_round_noise``) at ROADMAP
  C4's bound: every parameter within one uplink code step, 99.9 % within
  1e-5, the loss within rtol 1e-4;
* the real JAX ``make_fl_round`` on a (2, 4) host mesh in rsag and paper,
  its parameters placed by the reference's ``param_shardings`` as its
  trainer places them (a subprocess, on its own key-chain draws), the
  port's distributed round on those draws held to it at the C4 bound.
"""
import dataclasses
import hashlib
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.config.base import QuantConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import aggregation as agg
from repro_torch.core import comm as comm_mod
from repro_torch.core import quantization as quant
from repro_torch.core.fl import (RoundNoise, dist_round_noise,
                                 make_dist_fl_round, make_fl_round)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build_model
from repro_torch.population import fleet as tfleet
from repro_torch.sharding import rules as trules
from repro_torch.sharding.placement import gather_block, place_model

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0
FORMATS = ("paper", "int", "packed", "ring", "rsag")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The stacked replays run on one thread, as the ranks do: the
    parallel suite's workers contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# -- the wire ------------------------------------------------------------------

WIRE_D = 1001
WIRE_MESHES = {"2": ((2,), ("data",)), "4": ((4,), ("data",)),
               "3": ((3,), ("data",)), "2x2": ((2, 2), ("pod", "data")),
               "2x2x2": ((2, 2, 2), ("a", "b", "c"))}


def _wire_cases(C):
    cases = [(m, bits, hops, drop, "normal")
             for m in FORMATS for bits in (8, 4) for hops in (True, False)
             for drop in ("some", "all")]
    cases += [("int", 16, True, "some", "normal")]
    # a lane of 16 bits (cpw 2) with codes near +clip: the word sum's top
    # lane nears 2^16, so its words carry into bit 31
    cases += [("packed", 16 - quant.packed_lane_bits(0, C), True, "none",
               "near_clip")]
    return cases


def _wire_rows(C, drop, kind):
    rng = np.random.default_rng(C)
    if kind == "near_clip":
        x = np.full((C, WIRE_D), 0.999, np.float32)
    else:
        x = rng.normal(0, 0.3, (C, WIRE_D)).astype(np.float32)
    u = rng.uniform(0, 1, (C, WIRE_D)).astype(np.float32)
    lam = np.ones(C, np.float32)
    if drop == "some":
        lam[1::2] = 0
    elif drop == "all":
        lam[:] = 0
    return torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(lam)


def _wire_rank(rank, world, init, shape, axes):
    torch.set_num_threads(1)
    comm_mod.init_process_group("gloo", rank, world, "cpu", init_method=init)
    try:
        comm = comm_mod.Comm(tmesh.make_mesh(shape, axes), axes, "cpu")
        C, c = comm.num_cohorts, comm.cohort
        out = {"cohort": c, "index": {a: comm.axis_index(a) for a in axes}}
        for case in _wire_cases(C):
            mode, bits, hops, drop, kind = case
            plan = agg.make_wire_plan(mode, QuantConfig(
                bits=bits, pipeline_hops=hops), comm.axes, comm.axis_sizes)
            x, u, lam = _wire_rows(C, drop, kind)
            before = dict(comm.sent)
            got = agg.aggregate_rank(plan, comm, x[c:c + 1], 1.0 / C,
                                     lam[c:c + 1], u[c:c + 1])
            sent = {k: comm.sent[k] - before[k] for k in before}
            out[case] = (got, sent["psum"] + sent["hop"])
        return out
    finally:
        comm_mod.destroy_process_group()


def _wire_bytes(plan, D):
    """The payload bytes one rank sends for the plan, each message padded
    to whole 32-bit words (int8 and int16 to whole elements and words)."""
    bits, sizes = plan.quant.bits, plan.axis_sizes
    pl = quant.packed_lane_bits
    if plan.effective == "paper":
        return 4 * D
    if plan.effective == "int":
        width = {torch.int8: 1, torch.int16: 2, torch.int32: 4}[
            agg._int_container(bits, plan.num_shards)]
        return width * D if width != 2 else 4 * -(-D // 2)
    if plan.effective == "packed":
        return 4 * quant.packed_words(D, bits,
                                      lane_bits=pl(bits, plan.num_shards))
    total, m = 0, 1
    for K in (k for k in sizes if k > 1):
        if plan.effective == "ring":
            total += (K - 1) * 4 * quant.packed_words(
                D, bits, lane_bits=pl(bits, m))
        else:
            n = -(-D // K)
            total += sum(4 * quant.packed_words(n, bits,
                                                lane_bits=pl(bits, m * h))
                         for h in range(1, K))
            total += (K - 1) * 4 * quant.packed_words(
                n, bits, lane_bits=pl(bits, m * K))
        m *= K
    return total


@pytest.mark.parametrize("mesh", list(WIRE_MESHES))
def test_wire_matches_the_stacked_aggregate(mesh, tmp_path):
    shape, axes = WIRE_MESHES[mesh]
    C = math.prod(shape)
    out = run_ranks(_wire_rank, C, (shape, axes), workdir=str(tmp_path),
                    timeout_s=TIMEOUT_S)
    for r, res in enumerate(out):
        at = comm_mod.coords(tmesh.make_mesh(shape, axes), r)
        assert res["cohort"] == comm_mod.cohort_index(
            tmesh.make_mesh(shape, axes), r, axes) == r
        assert res["index"] == at
    for case in _wire_cases(C):
        mode, bits, hops, drop, kind = case
        plan = agg.make_wire_plan(mode, QuantConfig(bits=bits,
                                                    pipeline_hops=hops),
                                  axes, shape)
        x, u, lam = _wire_rows(C, drop, kind)
        want = agg.aggregate(plan, x, 1.0 / C, lam, u)
        for r in range(C):
            got, nbytes = out[r][case]
            if mode == "paper":
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=1e-6,
                    atol=1e-6 * float(want.abs().max()), err_msg=str(case))
            else:
                assert torch.equal(got, want), (case, r)
            assert nbytes == _wire_bytes(plan, WIRE_D), (case, r, nbytes)
            assert abs(nbytes * 8 / WIRE_D - plan.wire_bits) <= 32 * 8 / WIRE_D
        if drop == "all":
            assert not want.any()
        if kind == "near_clip":
            lane = quant.packed_lane_bits(bits, C)
            w = lam * float(np.float32(1.0 / C))
            words = ops.quantize_pack(x * (w * C)[:, None], u, bits,
                                      lane_bits=lane)
            assert lane == 16
            assert int(quant.from_int32_pattern(agg.sum_words(words)).max()) \
                >= 2 ** 31
            assert float(want.min()) > 0.99


class _Replicas:
    """A comm of C ranks that all hold this rank's row: its psum is C times
    the payload (modulo 2^32 for words), its gather C copies."""

    def __init__(self, C):
        self.axes, self.axis_sizes, self.num_cohorts = ("data",), (C,), C

    def gather(self, x):
        return x.expand(self.num_cohorts, *x.shape).clone()

    def psum(self, x):
        return x * self.num_cohorts


@pytest.mark.parametrize("bits, C", [(8, 128), (12, 8), (4, 2048)])
def test_int16_lanes_hold_the_container_limit(bits, C):
    """The int16 container rides as two biased lanes of an int32 word:
    at the largest C the container takes for ``bits``, codes at both ends
    of their range sum without a carry between the lanes, equal to the
    stacked int16 sum, and the plan prices 16 bits a parameter."""
    assert agg._int_container(bits, C) == torch.int16
    assert agg._int_container(bits, 2 * C) == torch.int32
    plan = agg.make_wire_plan("int", QuantConfig(bits=bits), ("data",), (C,))
    assert plan.wire_bits == 16.0
    rng = np.random.default_rng(bits)
    x = np.concatenate([np.ones(50), -np.ones(51),
                        rng.normal(0, 0.3, 100)]).astype(np.float32)
    u = rng.uniform(0, 1, x.size).astype(np.float32)
    x, u = torch.from_numpy(x)[None], torch.from_numpy(u)[None]
    got = agg.aggregate_rank(plan, _Replicas(C), x, 1.0 / C, torch.ones(1), u)
    want = agg.aggregate(plan, x.expand(C, -1), 1.0 / C, torch.ones(C),
                         u.expand(C, -1))
    assert torch.equal(got, want)
    top = 1 - 2.0 ** (1 - bits)                  # the code G - 1
    assert float(got[:50].min()) >= top - 1e-6
    assert float(got[50:101].max()) <= -1 + 1e-6


# -- reduced olmo-1b on 8 ranks ------------------------------------------------

SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
         "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512")
I, B, Q, LR, SEQ = 2, 16, 0.3, 0.5, 32
ROUND = SMALL + ("model.dtype=float32", f"train.seq_len={SEQ}",
                 f"channel.error_prob={Q}", f"fl.local_iters={I}",
                 f"fl.learning_rate={LR}", f"train.global_batch={B}")
#: name -> (collective, pipeline_hops, extra overrides); 2 rounds each
OLMO_RUNS = {"paper": ("paper", True, ()), "int": ("int", True, ()),
             "packed": ("packed", True, ()), "ring": ("ring", True, ()),
             "ring_seq": ("ring", False, ()), "rsag": ("rsag", True, ()),
             "rsag_seq": ("rsag", False, ()),
             # bfloat16 with the model ranks as replicas (dp_over_model:
             # the rules shard no leaf), and tensor-parallel
             "int_bf16": ("int", True, ("model.dtype=bfloat16",
                                        "train.dp_over_model=true")),
             "int_bf16_tp": ("int", True, ("model.dtype=bfloat16",))}
QUANTIZED = ("int", "packed", "ring", "ring_seq", "rsag", "rsag_seq")
OLMO_ROUNDS = 2
OLMO_MESHES = {"2x4": ((2, 4), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FLEET = {"size": 16, "selection": "rate_aware", "error_reweight": True}


def _cfg(*extra, fleet=False):
    cfg = apply_overrides(reduced(get_config("olmo-1b")), ROUND + extra)
    if fleet:
        cfg = dataclasses.replace(cfg, fleet=dataclasses.replace(cfg.fleet,
                                                                 **FLEET))
    return cfg


def _with_hops(cfg, hops):
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, pipeline_hops=hops))


def _batch(r):
    rng = np.random.default_rng(100 + r)
    tok = torch.from_numpy(rng.integers(0, 512, (B, SEQ)).astype(np.int32))
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def _digest(flat) -> str:
    h = hashlib.sha256()
    for b in (flat if isinstance(flat, tuple) else (flat,)):
        h.update(b.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _olmo_rank(rank, world, init, ref):
    """Every mesh of OLMO_MESHES in one process group (each rank makes
    each mesh's subgroups in the same order)."""
    torch.set_num_threads(1)
    comm_mod.init_process_group("gloo", rank, world, "cpu", init_method=init)
    try:
        return {name: _olmo_mesh(rank, shape, axes,
                                 ref if name == "2x4" else None)
                for name, (shape, axes) in OLMO_MESHES.items()}
    finally:
        comm_mod.destroy_process_group()


def _gathered(placed, params):
    """The whole parameters from this rank's blocks (a collective over the
    model group), and the digests of its blocks and of its replicated
    leaves."""
    if placed.placement is None:                # replicas
        return params, _digest(params), _digest(params)
    leaves = convert.unflatten_params(params, placed.param_shapes)
    whole = {k: gather_block(placed, k, v) for k, v in leaves.items()}
    repl = {k: v for k, v in leaves.items() if trules.model_dim(
        placed.placement.specs[k]) is None}
    return (convert.flatten_params(whole), _digest(params),
            _digest(tuple(repl.values())))


def _olmo_mesh(rank, shape, axes, ref):
    comm = comm_mod.Comm(tmesh.make_mesh(shape, axes), ("pod", "data"),
                         "cpu")
    out = {"cohort": comm.cohort, "model_index": comm.model_index,
           "runs": {}}
    for name, (collective, hops, extra) in OLMO_RUNS.items():
        cfg = _with_hops(_cfg(*extra), hops)
        placed = place_model(build_model(cfg), cfg, comm)
        # the first rank of each cohort group holds seed 1's blocks, and
        # its broadcast overwrites the others'
        params = comm.broadcast_(placed.init_flat(
            1 if comm.cohort == 0 else rank + 11, device="cpu"))
        fn = make_dist_fl_round(placed, cfg, comm, collective=collective)
        gen = torch.Generator().manual_seed(7)
        hist = []
        for r in range(OLMO_ROUNDS):
            params, m = fn(params, _batch(r), gen)
            whole, blocks, repl = _gathered(placed, params)
            hist.append((_digest(whole), float(m["loss"]),
                         float(m["survivors"]), m["wire_bits_per_param"],
                         blocks, repl, whole if rank == 0 else None))
        out["runs"][name] = (hist, whole if rank == 0 else None)
    cfg = _cfg(fleet=True)
    placed = place_model(build_model(cfg), cfg, comm)
    params = comm.broadcast_(placed.init_flat(1, device="cpu"))
    fleet = tfleet.init_fleet(3, cfg, device="cpu")
    fn = make_dist_fl_round(placed, cfg, comm, collective="rsag")
    gen = torch.Generator().manual_seed(9)
    new, m, fleet = fn(params, _batch(0), gen, fleet)
    whole = _gathered(placed, new)[0]
    out["fleet"] = (_digest(whole), _digest(tuple(fleet)),
                    float(m["survivors"]), whole if rank == 0 else None)
    if ref is not None:
        out["ref"] = {}
        for mode in ("rsag", "paper"):
            cfg = _cfg()
            placed = place_model(build_model(cfg), cfg, comm)
            fn = make_dist_fl_round(placed, cfg, comm, collective=mode)
            init = placed.placement.take_wire(torch.from_numpy(ref["init"]))
            new, m = fn(init, ref["batch"], noise=RoundNoise(
                None, torch.from_numpy(ref["u_up"]),
                torch.from_numpy(ref["lam"])))
            out["ref"][mode] = (_gathered(placed, new)[0], float(m["loss"]),
                                float(m["survivors"]),
                                m["wire_bits_per_param"])
    return out


_JAX_ROUND = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.config.base import apply_overrides
from repro.configs import get_config, reduced
from repro.core import channel as ch
from repro.core.fl import make_fl_round
from repro.models import build_model
from repro.sharding.rules import param_shardings
from repro.utils.compat import make_mesh, set_mesh

C, Q, SEED = 2, {Q}, 5
cfg = apply_overrides(reduced(get_config("olmo-1b")), {ROUND!r})
mesh = make_mesh((2, 4), ("data", "model"))
flat = lambda p: np.concatenate([np.asarray(x, np.float32).ravel()
                                 for x in jax.tree_util.tree_leaves(p)])
data = np.random.default_rng(0)
tok = data.integers(0, 512, ({B}, {SEQ})).astype(np.int32)
batch = {{"tokens": tok, "labels": np.roll(tok, -1, 1)}}
rng = jax.random.PRNGKey(SEED)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(1))
out = dict(batch, init=flat(params))
p_shardings = param_shardings(model, cfg, mesh)   # as the trainer places them
with set_mesh(mesh):
    placed = jax.device_put(params, p_shardings)
    for mode in ("rsag", "paper"):
        fn = jax.jit(make_fl_round(model, cfg, mesh, collective=mode),
                     in_shardings=(p_shardings, None, None),
                     out_shardings=(p_shardings, None))
        new, m = fn(placed, batch, rng)
        out[mode + "/params"] = flat(new)
        for k in ("loss", "survivors", "wire_bits_per_param"):
            out[mode + "/" + k] = np.float32(m[k])
leaves = jax.tree_util.tree_leaves(params)

def leaf_noise(key):      # split(key, n_leaves), one uniform draw per leaf
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.uniform(
        k, x.shape, jnp.float32)).ravel() for k, x in zip(keys, leaves)])

u_up, lam = [], []
for c in range(C):        # _shard_rng folds in the data axis only
    rc = jax.random.fold_in(rng, c)
    lam.append(float(ch.sample_packet_success(jax.random.fold_in(rc, 11), (), Q)))
    u_up.append(leaf_noise(jax.random.fold_in(rc, 13)))
np.savez(sys.argv[1], u_up=np.array(u_up), lam=np.array(lam, np.float32), **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The real JAX round on a (2, 4) host mesh, with its draws."""
    path = tmp_path_factory.mktemp("jax") / "round.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX_ROUND).format(Q=Q, B=B, SEQ=SEQ, ROUND=ROUND)
    r = subprocess.run([sys.executable, "-c", code, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def olmo(tmp_path_factory, reference):
    ref = {"init": reference["init"], "u_up": reference["u_up"],
           "lam": reference["lam"],
           "batch": {k: torch.from_numpy(reference[k])
                     for k in ("tokens", "labels")}}
    out = run_ranks(_olmo_rank, 8, (ref,),
                    workdir=str(tmp_path_factory.mktemp("olmo")),
                    timeout_s=4 * TIMEOUT_S)
    return {name: [o[name] for o in out] for name in OLMO_MESHES}


def _c4(got, want, what):
    """ROADMAP C4's bound: each parameter within one uplink code step (plus
    a float32 ulp of 1), 99.9 % within 1e-5.  Returns whether they are
    ``torch.equal``."""
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 1 / 128 + 1e-7, (what, diff.max())
    assert (diff <= 1e-5).mean() >= 0.999, (what, (diff <= 1e-5).mean())
    return bool((diff == 0).all())


@pytest.mark.parametrize("mesh", list(OLMO_MESHES))
def test_olmo_replicas_equal_after_every_round(olmo, mesh):
    """Tensor-parallel over "model": the gathered parameters equal on every
    rank, the blocks on the ranks of one model index, the replicated
    leaves on every rank; the loss and survivors on every rank."""
    out = olmo[mesh]
    shape, axes = OLMO_MESHES[mesh]
    m = tmesh.make_mesh(shape, axes)
    assert [o["cohort"] for o in out] == [
        comm_mod.cohort_index(m, r, ("pod", "data")) for r in range(len(out))]
    assert [o["model_index"] for o in out] == [
        comm_mod.coords(m, r)["model"] for r in range(len(out))]
    for name in OLMO_RUNS:
        for r in range(OLMO_ROUNDS):
            digests = {o["runs"][name][0][r][0] for o in out}
            assert len(digests) == 1, (name, r)
            metrics = {o["runs"][name][0][r][1:3] for o in out}
            assert len(metrics) == 1, (name, r, metrics)
            assert len({o["runs"][name][0][r][5] for o in out}) == 1
            for i in range(m["model"]):
                blocks = {o["runs"][name][0][r][4] for o in out
                          if o["model_index"] == i}
                assert len(blocks) == 1, (name, r, i)
            placed = "train.dp_over_model=true" not in OLMO_RUNS[name][2]
            assert len({o["runs"][name][0][r][4] for o in out}) == (
                m["model"] if placed else 1)


@pytest.mark.parametrize("mesh", list(OLMO_MESHES))
def test_olmo_quantized_formats_equal_each_other(olmo, mesh):
    runs = olmo[mesh][0]["runs"]
    for name in QUANTIZED:
        for r in range(OLMO_ROUNDS):
            assert runs[name][0][r][0] == runs["int"][0][r][0], (name, r)
    assert runs["paper"][0][0][3] == 32.0 and runs["int"][0][0][3] == 16.0


@pytest.mark.parametrize("mesh", list(OLMO_MESHES))
def test_olmo_fleet_replicas_read_one_lambda(olmo, mesh):
    """The fleet's update runs replicated and cohort c reads lam[c] on every
    replica: fleets and parameters equal on every rank, and the stacked
    fleet round on the same draws within the C4 bound."""
    out = olmo[mesh]
    assert len({o["fleet"][:3] for o in out}) == 1
    shape, axes = OLMO_MESHES[mesh]
    C = tmesh.cohort_axis_sizes(tmesh.make_mesh(shape, axes), ("pod", "data"))
    cfg = _cfg(fleet=True)
    model = build_model(cfg)
    params = model.init_flat(1, device="cpu")
    fleet = tfleet.init_fleet(3, cfg, device="cpu")
    g = torch.Generator().manual_seed(9)
    tfleet.round_update(fleet, g, cfg, model.param_shapes.numel, math.prod(C))
    noise = dist_round_noise(model, cfg, g, math.prod(C),
                             model.param_shapes.numel)
    fn = make_fl_round(model, cfg, C, collective="rsag", device="cpu")
    want, m, _ = fn(params, _batch(0), torch.Generator().manual_seed(9),
                    fleet, noise=noise)
    assert 0 < float(m["survivors"]) == out[0]["fleet"][2]
    _c4(out[0]["fleet"][3], want, "fleet")


@pytest.mark.parametrize("mesh", list(OLMO_MESHES))
def test_olmo_round_within_c4_of_the_stacked_round(olmo, mesh):
    """The stacked round fed the distributed round's draws
    (``dist_round_noise`` of the same generator), round after round.  In
    bfloat16 with the model ranks as replicas (``int_bf16``), the whole
    trajectory at the bound of ``tests/test_torch_lm_round.py``.  In
    bfloat16 tensor-parallel (``int_bf16_tp``) the forward and backward
    round partial sums that the whole products do not (a split over heads,
    ff columns and the vocabulary), which moves a parameter's delta by a
    bfloat16 ulp of its gradient and so its uplink code by a step now and
    then; each round's replay starts from the distributed round's
    parameters before it (ROADMAP C8), held to a code step and two
    bfloat16 ulps, 99 % equal."""
    out = olmo[mesh][0]
    shape, axes = OLMO_MESHES[mesh]
    sizes = tmesh.cohort_axis_sizes(tmesh.make_mesh(shape, axes),
                                    ("pod", "data"))
    C = math.prod(sizes)
    for name, (collective, hops, extra) in OLMO_RUNS.items():
        cfg = _with_hops(_cfg(*extra), hops)
        model = build_model(cfg)
        params = model.init_flat(1, device="cpu")
        fn = make_fl_round(model, cfg, sizes, collective=collective,
                           device="cpu")
        gen = torch.Generator().manual_seed(7)
        for r in range(OLMO_ROUNDS):
            noise = dist_round_noise(model, cfg, gen, C,
                                     model.param_shapes.numel)
            if name == "int_bf16_tp" and r:
                params = out["runs"][name][0][r - 1][6]
            params, m = fn(params, _batch(r), noise=noise)
            _, loss, surv, bits = out["runs"][name][0][r][:4]
            assert surv == float(m["survivors"]), (name, r)
            assert bits == m["wire_bits_per_param"], (name, r)
            np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4,
                                       err_msg=name)
            if name == "int_bf16_tp":
                want = params.float()
                diff = (out["runs"][name][0][r][6].float() - want).abs()
                assert bool((diff <= 1 / 128 + want.abs() * 2 ** -6).all()), \
                    (name, r, float(diff.max()))
                assert float((diff == 0).float().mean()) >= 0.99, (name, r)
        if name == "int_bf16":
            # bfloat16: a code step and a bfloat16 ulp, 99 % equal (the
            # bound of tests/test_torch_lm_round.py)
            want = params.float()
            diff = (out["runs"][name][1].float() - want).abs()
            assert bool((diff <= 1 / 128 + want.abs() * 2 ** -7).all()), name
            assert float((diff == 0).float().mean()) >= 0.99, name
        elif name != "int_bf16_tp":
            _c4(out["runs"][name][1], params, name)


def test_olmo_round_within_c4_of_the_real_make_fl_round(olmo, reference):
    """The reference's round on a (2, 4) host mesh (its own draws) against
    the port's distributed round on 8 ranks fed those draws."""
    z = reference
    for rank, out in enumerate(olmo["2x4"]):
        for mode in ("rsag", "paper"):
            new, loss, surv, bits = out["ref"][mode]
            assert surv == z[mode + "/survivors"], (mode, rank)
            assert np.float32(bits) == z[mode + "/wire_bits_per_param"]
            np.testing.assert_allclose(loss, z[mode + "/loss"], rtol=1e-4)
            assert np.abs(z[mode + "/params"] - z["init"]).max() > 1 / 128
            _c4(new, z[mode + "/params"], (mode, rank))
