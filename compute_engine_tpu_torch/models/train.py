"""Brief QAT training on synthetic data: realistic weights and BN statistics.

The port of ``compute_engine_tpu.models.train``. A few Adam steps of
straight-through-estimator training (``layers.ste_sign`` carries the
clipped-identity gradient) on a synthetic *clustered* dataset (class
prototypes plus noise), with the observed batch statistics written into the
BN moving statistics. The result is a parameter tree whose logits separate
the classes and whose BN folds are realistic: the substrate of the accuracy
records (``tests/fixtures/torch_accuracy_224.json``), which hold every packed
path against the float oracle with trained weights.

The data come from numpy generators exactly as in the JAX package, so one
seed gives the same batches in both. In place of optax: ``torch.optim.Adam``
with optax's defaults, ``clip_by_global_norm`` (optax's formula) for the
global-norm clip, and
``F.cross_entropy`` on the logits. Training and the statistics' collection
run with TF32 off (``device.exact_float32``), in float32 throughout, and
with deterministic algorithms only (``device.deterministic``): one seed
gives one set of weights on the card, as it does in the JAX package.

This is not a training framework; it exists to make honest conversion-
accuracy evidence.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import deterministic, exact_float32, resolve_device
from . import layers as L
from .builder import FloatBuilder, _on

__all__ = ["TrainBuilder", "make_prototypes", "clustered_batch",
           "synthetic_clustered", "clip_by_global_norm", "train_briefly",
           "recalibrate_bn_stats"]


class TrainBuilder(FloatBuilder):
    """QAT float forward that normalises with BATCH statistics (training
    mode).

    Records each BN's batch (mean, biased variance) in ``batch_stats`` and
    returns float32 logits from ``softmax``, for ``F.cross_entropy``.
    ``bn_eps`` is the training-only epsilon (a channel whose binary conv
    output is constant over a batch has variance 0, and the backward then
    scales by ``rsqrt(eps)``); inference and conversion keep Keras' 1e-5.
    """

    def __init__(self, params, bn_eps=L.BN_EPSILON):
        super().__init__(params)
        self.batch_stats = {}
        self.bn_eps = bn_eps

    def _apply_bn(self, y, name):
        dims = tuple(range(y.dim() - 1))
        mean = y.mean(dim=dims)
        var = y.var(dim=dims, unbiased=False)
        self.batch_stats[name] = (mean, var)
        bn = _on(self.params[name]["bn"], y)
        scale = bn["gamma"] * torch.rsqrt(var + self.bn_eps)
        return (y - mean) * scale + bn["beta"]

    def softmax(self, x):
        return x.to(torch.float32)  # logits; the loss applies log-softmax


def make_prototypes(seed, size, num_classes):
    """Unit-norm class prototype images, deterministic in ``seed``. Train
    and evaluation batches share them, so the trained logits are decisive."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (num_classes, *size, 3)).astype(np.float32)
    protos /= np.sqrt((protos ** 2).mean(axis=(1, 2, 3), keepdims=True))
    return protos


def clustered_batch(protos, rng, batch, spread=0.35):
    """One labelled batch drawn around the given prototypes."""
    y = rng.integers(0, len(protos), batch)
    x = protos[y] + rng.normal(0, spread, (batch, *protos.shape[1:]))
    return x.astype(np.float32), y


def synthetic_clustered(rng, batch, size, num_classes, spread=0.35,
                        protos=None):
    """Endless stream of clustered batches (prototypes drawn from ``rng``
    unless given)."""
    if protos is None:
        protos = make_prototypes(rng, size, num_classes)
    while True:
        yield clustered_batch(protos, rng, batch, spread)


def _tensors(params, device):
    """A parameter tree as fresh float32 leaf tensors on ``device``."""
    if isinstance(params, dict):
        return {k: _tensors(v, device) for k, v in params.items()}
    return torch.tensor(np.asarray(params, np.float32), device=device)


def _numpy(params):
    if isinstance(params, dict):
        return {k: _numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    else:
        yield params


def clip_by_global_norm(grads, max_norm):
    """Scale the gradient tensors ``grads`` in place as
    ``optax.clip_by_global_norm`` does: where their global norm (over every
    leaf; a leaf with no gradient adds nothing, as optax's zero gradient of
    a moving statistic adds nothing) reaches ``max_norm``, each becomes
    ``(g / norm) * max_norm``. Unlike ``torch.nn.utils.clip_grad_norm_``
    there is no epsilon beside the norm, and a norm under ``max_norm``
    leaves them as they are."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


def train_briefly(spec, params, *, steps=40, batch=32, lr=2e-3, seed=0,
                  num_classes=None, bn_momentum=0.7, data=None, protos=None,
                  clip_norm=None, bn_eps=L.BN_EPSILON, device="cuda"):
    """A few Adam+STE steps on ``device`` (the card by default); returns a
    trained numpy parameter tree and ``{"loss_first", "loss_last"}``.

    BN moving statistics become the running average of the observed batch
    statistics (Keras: ``m * old + (1 - m) * batch``, ``m = bn_momentum``).
    ``clip_norm``: optional global-norm gradient clipping. ``bn_eps``: the
    training-mode BN epsilon (see ``TrainBuilder``).
    """
    device = resolve_device(device)
    num_classes = num_classes or spec.num_classes
    rng = np.random.default_rng(seed)
    stream = data if data is not None else synthetic_clustered(
        rng, batch, spec.input_size, num_classes, protos=protos)
    p = _tensors(dict(params), device)
    leaves = list(_leaves(p))
    for t in leaves:
        t.requires_grad_(True)
    # Moving statistics get no gradient, so Adam leaves them alone, as
    # optax's update of a zero gradient does.
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    with exact_float32(), deterministic():
        for _ in range(steps):
            x, y = next(stream)
            b = TrainBuilder(p, bn_eps=bn_eps)
            logits = spec.forward(b, torch.from_numpy(np.asarray(x)).to(
                device))
            loss = F.cross_entropy(logits, torch.from_numpy(
                np.asarray(y)).to(device=device, dtype=torch.int64))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if clip_norm:
                clip_by_global_norm(
                    [t.grad for t in leaves if t.grad is not None], clip_norm)
            opt.step()
            with torch.no_grad():
                for name, (mean, var) in b.batch_stats.items():
                    bn = p[name]["bn"]
                    bn["moving_mean"].copy_(
                        bn_momentum * bn["moving_mean"]
                        + (1 - bn_momentum) * mean)
                    bn["moving_variance"].copy_(
                        bn_momentum * bn["moving_variance"]
                        + (1 - bn_momentum) * var)
            losses.append(float(loss.detach()))
    return _numpy(p), {"loss_first": losses[0], "loss_last": losses[-1]}


def recalibrate_bn_stats(spec, params, batches, device="cuda"):
    """Replace BN moving statistics with exact dataset statistics ("precise
    BN").

    Runs the forward in training mode (every BN normalising with its own
    batch statistics, the distribution the weights were trained under) over
    all ``batches`` (equal batch sizes) on ``device``, aggregates each BN's
    per-batch (mean, var) with the law of total variance, and writes the
    result into the moving statistics. Returns a new numpy parameter tree.
    """
    device = resolve_device(device)
    p = _tensors(dict(params), device)
    collected = {}
    with torch.no_grad(), exact_float32(), deterministic():
        for x in batches:
            b = TrainBuilder(p)
            spec.forward(b, torch.from_numpy(np.asarray(x, np.float32)).to(
                device))
            for name, (mean, var) in b.batch_stats.items():
                collected.setdefault(name, []).append(
                    (mean.cpu().numpy(), var.cpu().numpy()))
    out = _numpy(p)
    for name, mv in collected.items():
        means = np.stack([m for m, _ in mv])
        bvars = np.stack([v for _, v in mv])
        bn = out[name]["bn"]
        bn["moving_mean"] = means.mean(0)
        # Law of total variance over equally-sized batches.
        bn["moving_variance"] = bvars.mean(0) + means.var(0)
    return out
