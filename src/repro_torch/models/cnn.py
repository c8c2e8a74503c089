"""The paper's QNN (§IV): 2 quantized conv + 2 quantized FC layers on 28x28.

conv1: 32 @3x3 pad 1 stride 1 -> ReLU -> maxpool 2x2
conv2: 64 @3x3 pad 1 stride 1 -> ReLU -> maxpool 2x2
fc1:   3136 -> 128 -> ReLU
fc2:   128 -> 10

421,642 weights, 4,241,152 MACs/sample.  Parameters are a dict with the
reference's names and layouts — conv weights HWIO, dense weights (in, out)
— and images are NHWC, so parameters and batches carry across unchanged;
the forward permutes to PyTorch's NCHW/OIHW around each convolution.

``forward_stacked`` runs K clients with K different parameter sets in one
pass: the convolutions are grouped (``groups=K``, client k's sample b in
channel group k of batch row b) and the dense layers are ``bmm``.  It is
the one implementation: ``forward`` and ``loss`` run it at K=1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.config.base import Config
from repro_torch.core import quantization as quant
from repro_torch.device import DeviceLike, make_generator, resolve_device

Params = Dict[str, torch.Tensor]

IMAGE_SIZE = 28
NUM_CLASSES = 10

#: leaf shapes in leaf (sorted-key) order
PARAM_SHAPES: Dict[str, Tuple[int, ...]] = {
    "conv1_b": (32,), "conv1_w": (3, 3, 1, 32),
    "conv2_b": (64,), "conv2_w": (3, 3, 32, 64),
    "fc1_b": (128,), "fc1_w": (3136, 128),
    "fc2_b": (10,), "fc2_w": (128, 10),
}


def count_weights() -> int:
    conv1 = 32 * (3 * 3 * 1) + 32
    conv2 = 64 * (3 * 3 * 32) + 64
    fc1 = 3136 * 128 + 128
    fc2 = 128 * 10 + 10
    return conv1 + conv2 + fc1 + fc2


def count_macs() -> int:
    conv1 = 28 * 28 * 32 * (3 * 3 * 1)
    conv2 = 14 * 14 * 64 * (3 * 3 * 32)
    fc1 = 3136 * 128
    fc2 = 128 * 10
    return conv1 + conv2 + fc1 + fc2


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the last-but-one axis: logits
    (..., B, C), labels (..., B) -> (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean(dim=-1)


def _conv_relu_pool(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor,
                    groups: int) -> torch.Tensor:
    """x NCHW; w (G, 3, 3, Cin, Cout) HWIO per group; b (G, Cout)."""
    G, kh, kw, cin, cout = w_hwio.shape
    w = w_hwio.permute(0, 4, 3, 1, 2).reshape(G * cout, cin, kh, kw)
    x = F.conv2d(x, w, b.reshape(G * cout), stride=1, padding=1, groups=groups)
    return F.max_pool2d(F.relu(x), 2, 2)


@dataclass
class CNNModel:
    config: Config

    param_shapes = convert.Layout.uniform(PARAM_SHAPES, torch.float32)
    dtype = torch.float32

    @property
    def quantizes_training(self) -> bool:
        """The local steps train through the STE fake-quant (paper eq. 4),
        as the reference's QNN loss does whenever it gets a key."""
        qcfg = self.config.quant
        return qcfg.enabled and qcfg.quantize_training

    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device: DeviceLike = None) -> Params:
        """He-normal weights and zero biases from a seed or generator."""
        gen = make_generator(seed, resolve_device(device))

        def he(shape, fan):
            return torch.randn(shape, generator=gen, device=gen.device) * (2.0 / fan) ** 0.5

        zeros = lambda n: torch.zeros((n,), device=gen.device)
        return {
            "conv1_w": he((3, 3, 1, 32), 9), "conv1_b": zeros(32),
            "conv2_w": he((3, 3, 32, 64), 9 * 32), "conv2_b": zeros(64),
            "fc1_w": he((3136, 128), 3136), "fc1_b": zeros(128),
            "fc2_w": he((128, 10), 128), "fc2_b": zeros(10),
        }

    def forward_stacked(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        """K clients at once: leaves (K, ...), images (K, B, 28, 28, 1) ->
        logits (K, B, 10)."""
        K, B = images.shape[:2]
        # (B, K*1, H, W): channel group k of row b is client k's sample b
        x = images.float().permute(1, 0, 4, 2, 3).reshape(B, K, IMAGE_SIZE, IMAGE_SIZE)
        x = _conv_relu_pool(x, params["conv1_w"], params["conv1_b"], K)
        x = _conv_relu_pool(x, params["conv2_w"], params["conv2_b"], K)
        # (B, K*64, 7, 7) -> (K, B, 7, 7, 64) -> NHWC flatten per client
        x = x.reshape(B, K, 64, 7, 7).permute(1, 0, 3, 4, 2).reshape(K, B, -1)
        x = F.relu(torch.bmm(x, params["fc1_w"]) + params["fc1_b"][:, None, :])
        return torch.bmm(x, params["fc2_w"]) + params["fc2_b"][:, None, :]

    def forward(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        """One client: images (B, 28, 28, 1) NHWC -> logits (B, 10), through
        :meth:`forward_stacked` at K=1."""
        return self.forward_stacked({k: v[None] for k, v in params.items()},
                                    images[None])[0]

    def loss_stacked(self, params: Params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-client cross-entropy and accuracy, (K,) each, for leaves
        (K, ...) already fake-quantized by the caller and a batch with
        leaves (K, B, ...)."""
        logits = self.forward_stacked(params, batch["images"])
        ce = _cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean(-1)
        return ce, acc

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             u: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One client's QAT loss: forward through STE-fake-quantized weights
        (paper eq. 4), through :meth:`loss_stacked` at K=1.

        ``u`` is the flat fake-quant noise over the leaves in leaf order;
        None trains on the raw weights, as the reference does without a key.
        """
        qcfg = self.config.quant
        p = params
        if u is not None and qcfg.enabled and qcfg.quantize_training:
            p = quant.fake_quant_params(params, u, qcfg)
        ce, acc = self.loss_stacked({k: v[None] for k, v in p.items()},
                                    {k: v[None] for k, v in batch.items()})
        return ce[0], {"ce": ce[0], "accuracy": acc[0]}
