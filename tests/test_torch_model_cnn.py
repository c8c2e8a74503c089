"""The port's QNN (``repro_torch.models.cnn``) against ``repro.models.cnn``
on converted parameters and identical batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.transformer import _cross_entropy as j_cross_entropy
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.mnist_cnn import PAPER_MACS, PAPER_WEIGHTS
from repro_torch.models import build_model
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module")
def models():
    return jbuild_model(jget_config("mnist_cnn")), build_model(get_config("mnist_cnn"))


@pytest.fixture(scope="module")
def params_np(models):
    return {k: np.asarray(v) for k, v in models[0].init(jax.random.PRNGKey(1)).items()}


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_counts_match_the_paper():
    assert tcnn.count_weights() == 421_642 == PAPER_WEIGHTS
    assert tcnn.count_macs() == 4_241_152 == PAPER_MACS
    shapes = convert.param_shapes(build_model(get_config("mnist_cnn")).init(0, device="cpu"))
    assert shapes == tcnn.PARAM_SHAPES
    assert sum(int(np.prod(s)) for s in shapes.values()) == PAPER_WEIGHTS


@pytest.mark.parametrize("K", [1, 3])
def test_forward_matches_jax(models, params_np, K):
    """``forward`` (K=1) and ``forward_stacked`` (K clients, each with its own
    parameters) against the reference's forward, client by client."""
    jm, tm = models
    b = _batch(K * 8, 0)
    images = b["images"].reshape(K, 8, 28, 28, 1)
    clients = [{k: v * (1.0 + 0.1 * c) for k, v in params_np.items()} for c in range(K)]
    want = np.stack([np.asarray(jm.forward({k: jnp.asarray(v) for k, v in p.items()},
                                           jnp.asarray(images[c])))
                     for c, p in enumerate(clients)])
    if K == 1:
        got = tm.forward(convert.params_from_numpy(clients[0], "cpu"),
                         torch.from_numpy(images[0]))[None]
    else:
        stacked = {k: torch.from_numpy(np.stack([p[k] for p in clients]))
                   for k in params_np}
        got = tm.forward_stacked(stacked, torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [True, False])
def test_qat_loss_and_gradients_match_jax(models, params_np, quantized):
    jm, tm = models
    b = _batch(8, 1)
    key = jax.random.PRNGKey(5)
    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()},
        key if quantized else None)

    u = None
    if quantized:
        keys = jax.random.split(key, len(params_np))
        u = torch.from_numpy(np.concatenate([
            np.array(jax.random.uniform(k, params_np[n].shape, jnp.float32)).ravel()
            for k, n in zip(keys, sorted(params_np))]))
    tparams = {k: v.requires_grad_(True)
               for k, v in convert.params_from_numpy(params_np, "cpu").items()}
    tloss, tmet = tm.loss(tparams, _torch_batch(b), u)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    for k in params_np:
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6)


def test_stacked_forward_equals_single_forwards(models):
    tm = models[1]
    K, B = 3, 4
    singles = [tm.init(s, device="cpu") for s in range(K)]
    stacked = {k: torch.stack([p[k] for p in singles]) for k in singles[0]}
    images = torch.from_numpy(np.random.default_rng(2).normal(
        size=(K, B, 28, 28, 1)).astype(np.float32))
    got = tm.forward_stacked(stacked, images)
    assert got.shape == (K, B, 10)
    for k in range(K):
        torch.testing.assert_close(got[k], tm.forward(singles[k], images[k]),
                                   rtol=1e-5, atol=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 10)).astype(np.float32) * 4
    labels = rng.integers(0, 10, 6).astype(np.int32)
    want = float(j_cross_entropy(jnp.asarray(logits)[:, None, :],
                                 jnp.asarray(labels)[:, None]))
    got = float(tcnn._cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_flatten_roundtrip_in_leaf_order(params_np):
    p = convert.params_from_numpy(params_np, "cpu")
    flat = convert.flatten_params(p)
    want = np.concatenate([params_np[k].ravel() for k in sorted(params_np)])
    np.testing.assert_array_equal(flat.numpy(), want)
    back = convert.params_to_numpy(convert.unflatten_params(flat, convert.param_shapes(p)))
    for k in params_np:
        np.testing.assert_array_equal(back[k], params_np[k])
    stacked = convert.flatten_params({k: torch.stack([v, 2 * v]) for k, v in p.items()},
                                     batch_dims=1)
    assert stacked.shape == (2, PAPER_WEIGHTS)
    torch.testing.assert_close(stacked[1], 2 * flat)


def test_init_is_he_normal_and_seeded():
    tm = build_model(get_config("mnist_cnn"))
    a, b = tm.init(3, device="cpu"), tm.init(3, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert float(a["conv1_b"].abs().sum()) == 0.0
    np.testing.assert_allclose(float(a["fc1_w"].std()), (2.0 / 3136) ** 0.5, rtol=0.02)


def test_unported_family_raises():
    """Every family of the reference's zoo builds (the cnn's widths as a
    vlm give the decoder-only LM, as the reference's ``build_model``
    does); a family outside the zoo raises."""
    import dataclasses

    from repro_torch.models import LM
    cfg = get_config("mnist_cnn")
    vlm = build_model(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, family="vlm")))
    assert isinstance(vlm, LM)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, family="diffusion")))
