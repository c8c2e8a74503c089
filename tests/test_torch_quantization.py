"""The port's quantizer (``repro_torch.core.quantization``) against the
reference's on the same inputs and the reference's own noise draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import QuantConfig as JQuantConfig
from repro.configs import get_config as jget_config
from repro.core import quantization as jq
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.config.base import QuantConfig
from repro_torch.core import quantization as tq


def _leaf_noise(key, shapes):
    """The reference's per-leaf draws (split(key, n_leaves), uniform per
    leaf, ``quantization.py:42-43``) concatenated flat in leaf order."""
    keys = jax.random.split(key, len(shapes))
    return np.concatenate([np.asarray(jax.random.uniform(k, s, jnp.float32)).ravel()
                           for k, s in zip(keys, [shapes[n] for n in sorted(shapes)])])


def _qnn_params():
    cfg = jget_config("mnist_cnn")
    params = jbuild_model(cfg).init(jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("clip", [1.0, 0.5])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_fake_quant_ste_forward_and_gradient_match_jax(bits, clip):
    rng = np.random.default_rng(bits)
    x = rng.uniform(-1.4 * clip, 1.4 * clip, 3001).astype(np.float32)
    x[:4] = [clip, -clip, 0.0, np.nextafter(np.float32(clip), np.float32(2))]
    g = rng.normal(size=x.shape).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))

    def jloss(xx):
        return jnp.sum(jq.fake_quant_ste(xx, key, bits, clip, True) * g)

    jy = np.asarray(jq.fake_quant_ste(jnp.asarray(x), key, bits, clip, True))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tq.fake_quant_ste(xt, torch.from_numpy(u), bits, clip, True)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    np.testing.assert_array_equal(xt.grad.numpy(), jgrad)


def test_quantize_tree_over_qnn_leaves_matches_jax():
    params = _qnn_params()
    shapes = {k: v.shape for k, v in params.items()}
    cfg_j, cfg_t = JQuantConfig(bits=8), QuantConfig(bits=8)
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(_leaf_noise(key, shapes))
    tree_t = convert.params_from_numpy(params, "cpu")

    want = jq.quantize_tree({k: jnp.asarray(v) for k, v in params.items()}, key, cfg_j)
    got = tq.quantize_tree(tree_t, u, cfg_t)
    assert list(got) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    want_codes = jq.quantize_tree_codes({k: jnp.asarray(v) for k, v in params.items()},
                                        key, cfg_j)
    got_codes = tq.quantize_tree_codes(tree_t, u, cfg_t)
    np.testing.assert_array_equal(
        got_codes.numpy(),
        np.concatenate([np.asarray(want_codes[k]).ravel() for k in sorted(params)]))


def test_fake_quant_params_matches_jax():
    params = _qnn_params()
    shapes = {k: v.shape for k, v in params.items()}
    key = jax.random.PRNGKey(3)
    want = jq.fake_quant_params({k: jnp.asarray(v) for k, v in params.items()},
                                key, JQuantConfig(bits=4))
    got = tq.fake_quant_params(convert.params_from_numpy(params, "cpu"),
                               torch.from_numpy(_leaf_noise(key, shapes)),
                               QuantConfig(bits=4))
    for k in params:
        assert got[k].shape == params[k].shape
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(want[k]))


def test_quantization_disabled_passes_through():
    x = {"a": torch.ones(3)}
    assert tq.quantize_tree(x, None, QuantConfig(bits=0)) is x
    assert tq.fake_quant_params(x, None, QuantConfig(quantize_training=False)) is x


@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_payload_and_variance_bound_match_jax(bits):
    assert tq.payload_bits(421_642, bits) == jq.payload_bits(421_642, bits)
    for clip in (1.0, 0.3):
        assert tq.quantization_variance_bound(bits, clip) == \
            jq.quantization_variance_bound(bits, clip)


def test_stochastic_rounding_is_unbiased():
    gen = torch.Generator().manual_seed(0)
    x = torch.full((200_000,), 0.3)
    u = torch.rand(x.shape, generator=gen)
    y = tq.quantize(x, u, QuantConfig(bits=4))
    assert abs(float(y.mean()) - 0.3) < 1e-3
    assert float((y - x).abs().max()) <= 1.0 / 8 + 1e-7
