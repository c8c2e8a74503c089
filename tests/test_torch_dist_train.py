"""The trainer's distributed mode (``launch.train`` with ``--backend``)
and the launcher's failure paths, on gloo ranks on the CPU.

Ranks run as subprocesses (``launch.ranks.run_ranks``, a ``FileStore``
under ``tmp_path``), each with the environment ``torchrun`` would set.
At 4 ranks the mesh is (1, 4) over ("data", "model"), and reduced
olmo-1b runs tensor-parallel: each rank holds its blocks
(``sharding.placement``), and the checkpoint rank 0 writes holds the whole
tree, which a single process restores and the 4 ranks resume from.
"""
import json
import math
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config
from repro_torch.core import comm as comm_mod
from repro_torch.core.fl import dist_round_noise, make_fl_round
from repro_torch.data.synthetic import token_batch
from repro_torch.device import make_generator
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import cohort_axis_sizes, mesh_for_devices
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build_model
from repro_torch.sharding import rules as trules

pytestmark = pytest.mark.slow

TIMEOUT_S = 120.0
SMALL = ["model.n_layers=2", "model.d_model=128", "model.n_heads=4",
         "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512",
         "model.dtype=float32", "train.global_batch=8", "train.seq_len=32",
         "channel.error_prob=0.3", "fl.learning_rate=0.5"]
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The stacked replay runs on one thread, as the ranks do: the
    parallel suite's workers contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_rank(rank, world, init, ckpt_dir, tel_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    saves = []
    save = ckpt.save_params
    ckpt.save_params = lambda *a, **k: (saves.append(a[1]), save(*a, **k))
    argv = ["--arch", "olmo-1b", "--collective", "int", "--log-every", "1",
            "--backend", "gloo", "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", str(STEPS), *SMALL]
    out = ttrain.main(argv + ["--steps", str(STEPS), "--init-method", init,
                              "--telemetry-dir", tel_dir], device="cpu")
    # the 4 ranks resume from the checkpoint: no step left to run
    resumed = ttrain.main(argv + ["--steps", str(STEPS), "--init-method",
                                  init + "_resume"], device="cpu")
    return {k: out.get(k) for k in ("params", "loss", "kind", "cohorts",
                                    "rank", "telemetry_records",
                                    "comm_sent")} | {
        "saves": saves, "resumed": resumed["params"],
        "resumed_from": resumed["start_step"]}


def test_distributed_trainer_matches_the_stacked_round(tmp_path):
    """4 gloo ranks on the reference's mesh for 4 devices, (1, 4) over
    ("data", "model"), tensor-parallel: the checkpoint rank 0 alone saves
    holds the whole tree, every rank's parameters are its blocks of it
    (the replicated leaves equal on every rank), the 4 ranks resume from
    it into the same blocks, and it is within the C4 bound of the stacked
    round replayed on the same batches and draws (``fl.dist_round_noise``);
    the telemetry holds one record a step, numbered by step."""
    ckpt_dir, tel_dir = str(tmp_path / "ckpt"), str(tmp_path / "tel")
    out = run_ranks(_train_rank, 4, (ckpt_dir, tel_dir),
                    workdir=str(tmp_path / "ranks"), timeout_s=4 * TIMEOUT_S)
    assert [o["rank"] for o in out] == [0, 1, 2, 3]
    assert all(o["kind"] == "fl_round" and o["cohorts"] == 1 for o in out)
    for o in out[1:]:
        assert o["loss"] == out[0]["loss"]
    assert out[0]["saves"] == [STEPS] and all(not o["saves"] for o in out[1:])
    assert ckpt.latest_step(ckpt_dir) == STEPS
    assert out[0]["comm_sent"]["broadcast"] > 0
    assert out[0]["telemetry_records"] == STEPS
    assert all(o["telemetry_records"] is None for o in out[1:])
    with open(os.path.join(tel_dir, "telemetry.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["round"] for r in records] == list(range(STEPS))
    assert all(r["kind"] == "train_step" for r in records)
    assert records[-1]["loss"] == pytest.approx(out[0]["loss"], rel=1e-6)

    cfg = apply_overrides(get_config("olmo-1b"), tuple(SMALL))
    model = build_model(cfg)
    C = math.prod(cohort_axis_sizes(mesh_for_devices(4), cfg.fl.cohort_axes))
    D = model.param_shapes.numel
    params = model.init_flat(cfg.fl.seed, device="cpu")
    # the whole tree, restored into a single process
    restored = ckpt.restore_params(ckpt_dir, params, model.param_shapes)
    mesh = mesh_for_devices(4)
    specs = trules.param_specs(model, cfg, mesh)
    assert any(trules.model_dim(s) is not None for s in specs.values())
    local = convert.local_layout(model.param_shapes, specs, mesh)
    whole = convert.unflatten_params(restored, model.param_shapes)
    for rank, o in enumerate(out):
        at = comm_mod.coords(mesh, rank)
        assert o["resumed_from"] == STEPS
        assert o["params"].numel() == local.numel
        assert torch.equal(o["resumed"], o["params"])
        blocks = convert.unflatten_params(o["params"], local)
        for k, leaf in whole.items():
            assert torch.equal(blocks[k], convert.take_block(
                leaf, specs[k], mesh, at)), (rank, k)
    fn = make_fl_round(model, cfg, (C,), collective="int", device="cpu")
    gen = make_generator(cfg.fl.seed + 1, torch.device("cpu"))
    for _ in range(STEPS):
        batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                            cfg.model.vocab_size)
        params, m = fn(params, batch,
                       noise=dist_round_noise(model, cfg, gen, C, D))
    np.testing.assert_allclose(out[0]["loss"], float(m["loss"]), rtol=1e-4)
    diff = (restored - params).abs()
    assert float(diff.max()) <= 1 / 128 + 1e-7
    assert float((diff <= 1e-5).float().mean()) >= 0.999


def _nccl_rank(rank, world, init):
    try:
        comm_mod.init_process_group("nccl", rank, world, "cuda:0",
                                    init_method=init)
    except ValueError as e:
        return str(e)
    return None


def test_nccl_with_two_ranks_on_one_device_raises(tmp_path):
    out = run_ranks(_nccl_rank, 2, workdir=str(tmp_path),
                    timeout_s=TIMEOUT_S)
    assert all(o is not None and "share cuda:0" in o and "'gloo'" in o
               for o in out), out
    with pytest.raises(ValueError, match="gloo"):
        comm_mod.check_nccl_devices(["cuda:0", "cpu"])
    comm_mod.check_nccl_devices(["cuda:0", "cuda:1"])


def _failing_rank(rank, world, init, mode):
    torch.set_num_threads(1)
    comm_mod.init_process_group("gloo", rank, world, "cpu", init_method=init)
    if rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails")
        time.sleep(2 * comm_mod.TIMEOUT_S)
    dist.all_reduce(torch.ones(3))          # waits for rank 1
    return rank


@pytest.mark.parametrize("mode, error", [("raise", RuntimeError),
                                         ("hang", TimeoutError)])
def test_a_failed_or_hung_rank_fails_the_launcher(tmp_path, mode, error):
    """Rank 0 waits in a collective whose timeout is ``comm.TIMEOUT_S``
    (300 s); the launcher ends it as soon as rank 1 has raised, or at its
    own timeout when rank 1 hangs, and raises."""
    t0 = time.monotonic()
    with pytest.raises(error, match="rank 1" if mode == "raise" else "after"):
        run_ranks(_failing_rank, 2, (mode,), workdir=str(tmp_path),
                  timeout_s=10.0)
    assert time.monotonic() - t0 < 60
