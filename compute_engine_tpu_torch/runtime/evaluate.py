"""Accuracy evaluation harness: top-1/top-5 over a labelled dataset.

The port of ``compute_engine_tpu.runtime.evaluate``, the counterpart of the
Larq-Zoo ImageNet validation behind LCE's published top-1 numbers. The data
source is any iterable of (images, labels) batches, so it works with an
ImageNet directory loader or synthetic data; preprocessing follows the
standard Larq-Zoo/Keras ImageNet recipe (resize-256 center-crop-224,
per-channel mean).

Usage:
  python -m compute_engine_tpu_torch.runtime.evaluate --model quicknet \\
      --artifact q.npz --data imagenet_dir:/path/to/val [--batch 64] \\
      [--kernel auto] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.builder import KERNELS

__all__ = ["evaluate", "imagenet_preprocess", "synthetic_batches"]

# Keras/Larq-Zoo "caffe"-style ImageNet preprocessing constants.
_IMAGENET_MEAN = np.array([123.68, 116.779, 103.939], np.float32)


def imagenet_preprocess(images_uint8, size=224):
    """uint8 HWC images -> model input (resize shorter side 256, center crop,
    mean subtraction). Accepts (N, H, W, 3); runs on the host.

    The resize is bilinear with antialiasing when it shrinks, as
    ``jax.image.resize`` does; the two agree to the last bits of float32 on
    a 0-255 scale, not bit for bit."""
    x = torch.from_numpy(np.asarray(images_uint8, np.float32))
    n, h, w, _ = x.shape
    scale = 256.0 / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
        antialias=True, align_corners=False).permute(0, 2, 3, 1).numpy()
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size, :]
    return x - _IMAGENET_MEAN


def synthetic_batches(num_batches=4, batch=8, size=(224, 224),
                      num_classes=1000, seed=0):
    """Deterministic synthetic labelled data (for harness tests/smoke)."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        x = rng.normal(0, 1, (batch, *size, 3)).astype(np.float32)
        y = rng.integers(0, num_classes, batch)
        yield x, y


def evaluate(predict_fn, batches, top_k=(1, 5), progress_every=50):
    """Run top-k accuracy over (images, labels) batches.

    Args:
      predict_fn: (N, H, W, 3) -> (N, num_classes) probabilities/logits,
        numpy or a tensor (one on the card is brought back whole).
      batches: iterable of (images, labels).

    Returns dict with counts, accuracies and images/s.
    """
    correct = {k: 0 for k in top_k}
    total = 0
    t0 = time.perf_counter()
    for i, (images, labels) in enumerate(batches):
        probs = predict_fn(images)
        if isinstance(probs, torch.Tensor):
            probs = probs.cpu().numpy()
        probs = np.asarray(probs)
        order = np.argsort(-probs, axis=-1)
        labels = np.asarray(labels).reshape(-1)
        for k in top_k:
            correct[k] += int((order[:, :k] == labels[:, None]).any(-1).sum())
        total += len(labels)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  {total} images, top-1 so far "
                  f"{correct[top_k[0]] / total:.4f}")
    dt = time.perf_counter() - t0
    return {
        "images": total,
        **{f"top{k}": round(correct[k] / max(total, 1), 4) for k in top_k},
        "images_per_sec": round(total / dt, 2),
    }


def _imagenet_dir_batches(path, batch, size=224):
    """Minimal ImageNet-val directory loader: <path>/<class_dir>/* images
    with class dirs in sorted order mapped to label indices."""
    import os

    from PIL import Image  # only needed for directory evaluation

    classes = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)))
    files = [(os.path.join(path, c, f), i)
             for i, c in enumerate(classes)
             for f in sorted(os.listdir(os.path.join(path, c)))]
    for s in range(0, len(files), batch):
        chunk = files[s:s + batch]
        imgs = np.stack([
            np.asarray(Image.open(p).convert("RGB").resize((256, 256)))
            for p, _ in chunk])
        yield imagenet_preprocess(imgs, size), np.array(
            [l for _, l in chunk])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="quicknet")
    p.add_argument("--artifact", default=None)
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or 'imagenet_dir:/path'")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--kernel", default="auto", choices=KERNELS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..models import convert_model, get_model, init_model
    from .interpreter import Interpreter

    spec = get_model(args.model)
    if args.artifact:
        interp = Interpreter(artifact_path=args.artifact, model=spec,
                             kernel=args.kernel, device=args.device)
    else:
        layers = convert_model(spec, init_model(spec, seed=0,
                                                randomize_bn=True))
        interp = Interpreter(spec, layers, kernel=args.kernel,
                             device=args.device)

    if args.data.startswith("imagenet_dir:"):
        batches = _imagenet_dir_batches(args.data.split(":", 1)[1],
                                        args.batch)
    else:
        batches = synthetic_batches(batch=args.batch,
                                    num_classes=spec.num_classes)
    print(json.dumps(evaluate(interp.predict, batches)))


if __name__ == "__main__":
    main()
