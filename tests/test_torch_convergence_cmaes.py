"""The paper's §III planner on the port (``repro_torch.core.convergence``,
``cmaes`` and ``optimize``) against ``repro.core``: the nine cases of
``tests/test_convergence_cmaes.py``, the CMA-ES search bit for bit, the
energy objective on the reference's own fading bank, and the paper trends
of ``tests/test_fl_system.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import cmaes as jcmaes
from repro.core import optimize as joptimize
from repro_torch.config import ConvergenceConfig, FLConfig
from repro_torch.configs import get_config
from repro_torch.configs.mnist_cnn import PAPER_MACS, PAPER_WEIGHTS
from repro_torch.core import cmaes
from repro_torch.core import convergence as cv
from repro_torch.core import optimize

CFG = ConvergenceConfig()
FL = FLConfig()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops; under the suite's parallel
    workers a thread pool per op only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_variance_bound_components():
    """eq. 16 at the paper's constants (hand-computed)."""
    E = float(cv.variance_bound_E(CFG, FL, num_params=421_642, bits=8.0))
    grad_noise = 100 * 0.001 / 100 ** 2
    hetero = 6 * 0.097 * 0.6
    drift = (8 * 4 + 4 * 90 * 9 / (10 * 99)) * 0.25
    quant = 4 * 421_642 * 9 * 1e-4 / (10 * 255 ** 2)
    np.testing.assert_allclose(E, grad_noise + hetero + drift + quant, rtol=1e-5)


def test_variance_decreases_with_bits():
    e4, e8, e32 = (float(cv.variance_bound_E(CFG, FL, num_params=421_642,
                                             bits=b)) for b in (4.0, 8.0, 32.0))
    assert e4 > e8 > e32


def test_rounds_increase_with_drops_and_precision_loss():
    def T(bits, q):
        return float(cv.rounds_to_converge(CFG, FL, num_params=421_642,
                                           bits=bits, q=q))
    assert T(8.0, 0.5) > T(8.0, 0.01), "packet drops must slow convergence"
    assert T(2.0, 0.01) > T(8.0, 0.01), "coarser quantization must slow it"


def test_rigorous_v_bounds_recursion():
    q, bits = 0.1, 8.0
    E = cv.variance_bound_E(CFG, FL, num_params=1000, bits=bits)
    gamma = float(cv.gamma_param(CFG, FL, q))
    v = float(cv.v_param(CFG, FL, E=E, q=q, rigorous=True))
    traj = cv.bound_trajectory(CFG, FL, num_params=1000, bits=bits, q=q,
                               rounds=300)
    for t, d in enumerate(traj.numpy(), start=1):
        assert d <= v / (t + gamma) + 1e-9, f"bound violated at t={t}"


def test_paper_v_gap_documented():
    """The paper's v does not bound the recursion for q > 0; at q = 0 it
    reduces to Li et al.'s and holds."""
    q, bits = 0.1, 8.0
    E = cv.variance_bound_E(CFG, FL, num_params=1000, bits=bits)
    gamma = float(cv.gamma_param(CFG, FL, q))
    v_paper = float(cv.v_param(CFG, FL, E=E, q=q))
    traj = cv.bound_trajectory(CFG, FL, num_params=1000, bits=bits, q=q,
                               rounds=300).numpy()
    assert sum(d > v_paper / (t + gamma) + 1e-9
               for t, d in enumerate(traj, start=1)) > 0
    gamma0 = float(cv.gamma_param(CFG, FL, 0.0))
    v0 = float(cv.v_param(CFG, FL, E=E, q=0.0))
    traj0 = cv.bound_trajectory(CFG, FL, num_params=1000, bits=bits, q=0.0,
                                rounds=300).numpy()
    for t, d in enumerate(traj0, start=1):
        assert d <= v0 / (t + gamma0) + 1e-9


def test_convergence_matches_reference():
    from repro.config import ConvergenceConfig as JCV, FLConfig as JFL
    from repro.core import convergence as jcv
    for bits, q in ((4.0, 0.01), (8.0, 0.3), (32.0, 0.9), (5.5, 0.05)):
        for rigorous in (False, True):
            want = jcv.rounds_to_converge(JCV(), JFL(), num_params=421_642,
                                          bits=jnp.float32(bits),
                                          q=jnp.float32(q), rigorous=rigorous)
            got = cv.rounds_to_converge(CFG, FL, num_params=421_642,
                                        bits=bits, q=q, rigorous=rigorous)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        cv.bound_trajectory(CFG, FL, num_params=1000, bits=8.0, q=0.1,
                            rounds=50).numpy(),
        np.asarray(jcv.bound_trajectory(JCV(), JFL(), num_params=1000,
                                        bits=8.0, q=0.1, rounds=50)),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# CMA-ES
# ---------------------------------------------------------------------------

def test_cmaes_sphere():
    res = cmaes.minimize(lambda x: float(np.sum(x ** 2)),
                         [2.0, -1.5, 0.5], 0.5, max_iters=300, seed=0)
    assert res.f_best < 1e-10
    np.testing.assert_allclose(res.x_best, 0.0, atol=1e-4)


def test_cmaes_rosenbrock():
    ros = lambda x: float(100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2)
    res = cmaes.minimize(ros, [-1.0, 1.0], 0.5, max_iters=500, seed=1)
    assert res.f_best < 1e-8
    np.testing.assert_allclose(res.x_best, 1.0, atol=1e-3)


def test_cmaes_respects_box():
    res = cmaes.minimize(lambda x: float(np.sum((x - 5.0) ** 2)),
                         [0.5, 0.5], 0.3, lower=[0.0, 0.0], upper=[1.0, 1.0],
                         max_iters=200, seed=2)
    np.testing.assert_allclose(res.x_best, 1.0, atol=1e-3)


def test_cmaes_history_monotone():
    res = cmaes.minimize(lambda x: float(np.sum(x ** 2)), [3.0, 3.0], 1.0,
                         max_iters=100, seed=3)
    assert (np.diff(res.history_f) <= 1e-12).all()


@pytest.mark.parametrize("problem", ["sphere", "rosenbrock"])
def test_cmaes_bit_identical_to_reference(problem):
    if problem == "sphere":
        f, args = (lambda x: float(np.sum(x ** 2))), ([2.0, -1.5, 0.5], 0.5)
        kw = dict(max_iters=300, seed=0)
    else:
        f = lambda x: float(100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2)
        args, kw = ([-1.0, 1.0], 0.5), dict(max_iters=500, seed=1)
    got, want = cmaes.minimize(f, *args, **kw), jcmaes.minimize(f, *args, **kw)
    assert got.f_best == want.f_best and got.iterations == want.iterations
    for name in ("x_best", "history_x", "history_f", "history_sigma"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


# ---------------------------------------------------------------------------
# the energy objective and the paper's trends
# ---------------------------------------------------------------------------

def test_energy_objective_matches_reference_on_its_fading_bank():
    jobj = joptimize.EnergyObjective(jget_config("mnist_cnn"), PAPER_WEIGHTS,
                                     PAPER_MACS, seed=0)
    obj = optimize.EnergyObjective(get_config("mnist_cnn"), PAPER_WEIGHTS,
                                   PAPER_MACS, device="cpu",
                                   gain2=torch.from_numpy(np.array(jobj.gain2)))
    rng = np.random.default_rng(0)
    points = list(zip(rng.uniform(0.1, 2.0, 20), rng.uniform(0.01, 0.99, 20),
                      rng.choice([4.0, 8.0, 16.0, 32.0, 6.5], 20)))
    for p_tx, q, bits in points:
        got, want = obj.evaluate(p_tx, q, bits), jobj.evaluate(p_tx, q, bits)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{k} at {(p_tx, q, bits)}")


def test_joint_energy_optimization_matches_paper_trends():
    """CMA-ES drives q toward 0.01 (paper Fig. 2b) and FP8 saves about 75 %
    of FP32's energy at the optimum (Fig. 4), within the latency limit."""
    cfg = get_config("mnist_cnn")
    res = optimize.joint_optimize(cfg, num_params=PAPER_WEIGHTS,
                                  macs_per_iter=PAPER_MACS, max_iters=60,
                                  seed=0, device="cpu")
    assert res.q <= 0.05, f"q* should approach 0.01, got {res.q}"
    assert 0.1 <= res.p_tx <= 2.0
    assert res.tau_pr_s <= cfg.fl.tau_limit_s
    saving = 1 - res.per_bits[8]["energy_j"] / res.per_bits[32]["energy_j"]
    assert saving >= 0.70, f"FP8 should save ~75% vs FP32, got {saving:.2%}"


def test_energy_objective_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize.EnergyObjective(get_config("mnist_cnn"), PAPER_WEIGHTS,
                                 PAPER_MACS)
