"""The Larq-Zoo model family, defined once and executed by any builder.

A copy of ``compute_engine_tpu.models.zoo`` (pure Python): the port keeps its
own so that it imports nothing of the JAX package.

The reference engine's models come from the separate ``larq-zoo`` package;
its README benchmarks QuickNet-S/M/L and Bi-RealNet, and BASELINE.json adds
BinaryDenseNet-45. The architectures below are reconstructed from the
publications:

* QuickNet family — Bannink et al., "Larq Compute Engine: Design, Benchmark
  and Deploy State-of-the-Art Binarized Neural Networks", MLSys 2021.
  Binary 3x3 residual blocks with one-padding (LCE's pad_value=1 fast path),
  float stem (3x3 conv + depthwise + pointwise) and float transition
  (maxpool + pointwise conv) blocks.
* Bi-RealNet-18 — Liu et al., ECCV 2018. ResNet-18 topology with one binary
  3x3 conv per block and a real-valued shortcut; zero-padding (this is the
  model that exercises the reference's zero-padding-correction path,
  `core/bconv2d/zero_padding_correction.h`). Downsample shortcuts are
  2x2 average-pool + float 1x1 conv.
* BinaryDenseNet-28/37/45 — Bethge et al., "BinaryDenseNet: Developing an
  Architecture for Binary Neural Networks", ICCVW 2019. Dense blocks of
  binary 3x3 convs (growth 64), float 1x1 reduction + 2x2 avg-pool
  transitions, reduction rates per the paper's configurations.

NOTE: block counts/filters are faithful to the papers, but exact parity with
larq-zoo layer hyperparameters (initializers, minor stem details) cannot be
verified offline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelSpec", "MODELS", "get_model", "tiny_quicknet"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    forward: Callable  # (builder, x) -> logits-probabilities
    input_size: tuple[int, int] = (224, 224)
    num_classes: int = 1000


# ---------------------------------------------------------------------------
# QuickNet
# ---------------------------------------------------------------------------


def _quicknet_forward(b, x, *, section_filters, section_blocks,
                      num_classes=1000):
    f0 = section_filters[0]
    # Fast float stem: 3x3/2 conv -> depthwise 3x3/2 -> pointwise to f0.
    x = b.conv_bn(x, f0 // 4, 3, stride=2, activation="relu",
                  name="stem_conv")
    x = b.depthwise_conv_bn(x, 3, stride=2, activation="relu",
                            name="stem_depthwise")
    x = b.conv_bn(x, f0, 1, name="stem_pointwise")
    for s, (filters, blocks) in enumerate(
            zip(section_filters, section_blocks)):
        if s > 0:
            # Float transition: spatial downsample + channel expansion.
            x = b.max_pool(x, 2, 2)
            x = b.conv_bn(x, filters, 1, name=f"transition_{s}")
        for i in range(blocks):
            # Binary residual block: sign -> bconv3x3 (one-padding) -> BN ->
            # + residual. One-padding keeps the reference's fast path
            # (`prepare_patterns_common.td:136-168`).
            y = b.binary_conv_bn(x, filters, 3, pad_value=1,
                                 name=f"section_{s}_block_{i}")
            x = b.add(x, y)
    x = b.activation(x, "relu")
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def quicknet_small(b, x):
    return _quicknet_forward(b, x, section_filters=(64, 128, 256, 512),
                             section_blocks=(2, 3, 4, 4))


def quicknet(b, x):
    return _quicknet_forward(b, x, section_filters=(64, 128, 256, 512),
                             section_blocks=(4, 4, 4, 4))


def quicknet_large(b, x):
    return _quicknet_forward(b, x, section_filters=(64, 128, 256, 512),
                             section_blocks=(6, 8, 12, 6))


# ---------------------------------------------------------------------------
# Bi-RealNet-18
# ---------------------------------------------------------------------------


def birealnet18(b, x, *, num_classes=1000):
    x = b.conv_bn(x, 64, 7, stride=2, name="stem_conv")
    x = b.max_pool(x, 3, 2)
    filters = (64, 128, 256, 512)
    for s, f in enumerate(filters):
        for i in range(4):
            stride = 2 if (s > 0 and i == 0) else 1
            if stride == 2:
                # Real-valued downsample shortcut: avgpool + 1x1 conv + BN.
                shortcut = b.avg_pool(x, 2, 2, padding="SAME")
                shortcut = b.conv_bn(shortcut, f, 1,
                                     name=f"shortcut_{s}")
            else:
                shortcut = x
            # Bi-Real block: sign -> binary 3x3 (zero-padding!) -> BN.
            y = b.binary_conv_bn(x, f, 3, stride=stride, pad_value=0,
                                 name=f"stage_{s}_block_{i}")
            x = b.add(shortcut, y)
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


# ---------------------------------------------------------------------------
# BinaryResNet-E18 — Bethge et al. 2019 ("Back to Simplicity"): ResNet-18
# with one binary conv per block and a parameter-free downsample shortcut
# (2x2 average-pool + channel-duplicating concat).
# ---------------------------------------------------------------------------


def binary_resnet_e18(b, x, *, num_classes=1000):
    # No stem ReLU before the first block's sign (see the DenseNet note:
    # sign(relu(x)) is identically +1; ResNetE's stem is likewise
    # normalise-then-binarise, Bethge et al. 2019 Fig. 2).
    x = b.conv_bn(x, 64, 7, stride=2, name="stem_conv")
    x = b.max_pool(x, 3, 2)
    filters = (64, 128, 256, 512)
    for s, f in enumerate(filters):
        for i in range(4):
            downsample = s > 0 and i == 0
            if downsample:
                shortcut = b.avg_pool(x, 2, 2, padding="SAME")
                shortcut = b.concat([shortcut, shortcut])
                y = b.binary_conv_bn(x, f, 3, stride=2, pad_value=1,
                                     name=f"stage_{s}_block_{i}")
            else:
                shortcut = x
                y = b.binary_conv_bn(x, f, 3, pad_value=1,
                                     name=f"stage_{s}_block_{i}")
            x = b.add(shortcut, y)
    x = b.activation(x, "relu")
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


# ---------------------------------------------------------------------------
# BinaryAlexNet — Hubara et al. 2016 BinaryNet, AlexNet topology as shipped
# in larq-zoo literature: float first conv, binary convs + binary dense
# trunk, float classifier head.
# ---------------------------------------------------------------------------


def binary_alexnet(b, x, *, num_classes=1000):
    x = b.conv_bn(x, 96, 11, stride=4, name="stem_conv")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 256, 5, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 384, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 384, 3, pad_value=1, name="conv4")
    x = b.binary_conv_bn(x, 256, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 4096, name="fc1")
    x = b.binary_dense_bn(x, 4096, name="fc2")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


# ---------------------------------------------------------------------------
# BinaryDenseNet
# ---------------------------------------------------------------------------


def _binary_densenet_forward(b, x, *, layers_per_block, reductions,
                             growth_rate=64, initial_filters=64,
                             num_classes=1000):
    # NOTE (round-5 fidelity fix): no ReLU between the stem/transition BN
    # and the next block's sign quantizer. The paper's blocks are
    # pre-activation (BN -> sign -> conv); our conv->BN ending feeds the
    # next layer's sign, which is the same normalise-then-binarise order —
    # but an interposed ReLU makes sign(relu(x)) identically +1 (a ReLU
    # output is never negative), zeroing the batch variance of every
    # in-block binary conv and breaking training outright.
    x = b.conv_bn(x, initial_filters, 7, stride=2, name="stem_conv")
    x = b.max_pool(x, 3, 2)
    for block_idx, n_layers in enumerate(layers_per_block):
        for i in range(n_layers):
            # Dense layer: sign -> binary 3x3 -> BN, concatenated.
            y = b.binary_conv_bn(x, growth_rate, 3, pad_value=1,
                                 name=f"block_{block_idx}_layer_{i}")
            x = b.concat([x, y])
        if block_idx < len(layers_per_block) - 1:
            # Float transition: 1x1 reduction conv + 2x2 average pooling.
            channels = int(x.shape[-1] // reductions[block_idx] // 32) * 32
            x = b.conv_bn(x, channels, 1,
                          name=f"transition_{block_idx}")
            x = b.avg_pool(x, 2, 2)
    x = b.activation(x, "relu")
    x = b.global_avg_pool(x)
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


def binary_densenet28(b, x, *, num_classes=1000):
    return _binary_densenet_forward(
        b, x, layers_per_block=(6, 6, 6, 5), reductions=(2.7, 2.7, 2.2),
        num_classes=num_classes)


def binary_densenet37(b, x, *, num_classes=1000):
    return _binary_densenet_forward(
        b, x, layers_per_block=(6, 8, 12, 6), reductions=(3.3, 3.3, 4.0),
        num_classes=num_classes)


def binary_densenet45(b, x, *, num_classes=1000):
    return _binary_densenet_forward(
        b, x, layers_per_block=(6, 12, 14, 8), reductions=(2.7, 3.3, 4.0),
        num_classes=num_classes)


def tiny_quicknet(section_filters=(32, 64), section_blocks=(1, 1),
                  num_classes=16, input_size=32):
    """Reduced-QuickNet ModelSpec factory for tests / dry runs."""
    def fwd(b, x):
        return _quicknet_forward(b, x, section_filters=tuple(section_filters),
                                 section_blocks=tuple(section_blocks),
                                 num_classes=num_classes)
    name = (f"tiny_quicknet_{'x'.join(map(str, section_filters))}"
            f"_{'x'.join(map(str, section_blocks))}")
    return ModelSpec(name, fwd, input_size=(input_size, input_size),
                     num_classes=num_classes)


MODELS = {
    "quicknet_small": ModelSpec("quicknet_small", quicknet_small),
    "quicknet": ModelSpec("quicknet", quicknet),
    "quicknet_large": ModelSpec("quicknet_large", quicknet_large),
    "birealnet18": ModelSpec("birealnet18", birealnet18),
    "binary_resnet_e18": ModelSpec("binary_resnet_e18", binary_resnet_e18),
    "binary_alexnet": ModelSpec("binary_alexnet", binary_alexnet),
    "binary_densenet28": ModelSpec("binary_densenet28", binary_densenet28),
    "binary_densenet37": ModelSpec("binary_densenet37", binary_densenet37),
    "binary_densenet45": ModelSpec("binary_densenet45", binary_densenet45),
}


def get_model(name: str) -> ModelSpec:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODELS)}")
    return MODELS[name]
