"""The op-level user flow of the public API on the card.

The port of the JAX repo's ``examples/e2e_smoke.py``, at its shapes and
seed: a +-1 feature map is packed (``quantize``), convolved by ``bconv2d``
with each of three lowerings ("reference", the packed oracle; "bgemm", the
binary GEMM kernel; "mxu", +-1 int8 and the integer matmul), then run
through the bitpacked-output chain: thresholds against sign-flipped
filters, ``bmaxpool2d`` on the packed words and ``dequantize``. Unlike the
JAX file it does not only print: it exits non-zero if a lowering's output
differs from "reference" in any bit.

Usage: python -m compute_engine_tpu_torch.examples.e2e_smoke [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import (Activation, BConv2DParams, OutputTransform, Padding,
                    compute_output_thresholds, fuse_output_transform)
from ..device import resolve_device
from ..ops import bconv2d, bmaxpool2d, dequantize, quantize

__all__ = ["KERNELS", "inputs", "run", "main"]

KERNELS = ("reference", "bgemm", "mxu")


def inputs(seed=0):
    """The JAX example's numpy inputs: a +-1 map (2, 16, 16, 64), a +-1
    filter (128, 3, 3, 64), the BN multiplier and bias."""
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.0, 1.0], size=(2, 16, 16, 64)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], size=(128, 3, 3, 64)).astype(np.float32)
    post_mul = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    post_bias = rng.uniform(-2, 2, 128).astype(np.float32)
    return x, w, post_mul, post_bias


def run(device="cuda", seed=0):
    """The flow on ``device``. Returns a dict: ``float`` (lowering -> float
    output), ``bitpacked`` (lowering -> packed output of the threshold
    chain), ``pooled`` and ``dequantized`` (of the "mxu" chain)."""
    device = resolve_device(device)
    x, w, post_mul, post_bias = inputs(seed)
    params = BConv2DParams(channels_in=64, padding=Padding.SAME, pad_value=1,
                           activation=Activation.NONE)
    t = fuse_output_transform(post_mul, post_bias, 3 * 3 * 64)
    xp = quantize(torch.from_numpy(x).to(device))
    wp = quantize(torch.from_numpy(w).to(device))
    out = {"float": {k: bconv2d(xp, wp, t, params, "float", kernel=k)
                     for k in KERNELS}}
    # Bitpacked output: thresholds, computed against filters flipped by the
    # multiplier's sign.
    thr = compute_output_thresholds(post_mul, post_bias, 3 * 3 * 64)
    wflip = w * np.where(post_mul >= 0, 1.0, -1.0)[:, None, None, None]
    wfp = quantize(torch.from_numpy(wflip.astype(np.float32)).to(device))
    tp = OutputTransform(thresholds=thr)
    out["bitpacked"] = {k: bconv2d(xp, wfp, tp, params, "bitpacked",
                                   kernel=k) for k in KERNELS}
    out["pooled"] = bmaxpool2d(out["bitpacked"]["mxu"], 2, 2)
    out["dequantized"] = dequantize(out["pooled"], 128)
    return out


def unequal(out):
    """The (output kind, lowering) pairs that differ from "reference"."""
    return [(kind, k) for kind in ("float", "bitpacked") for k in KERNELS
            if not torch.equal(out[kind][k], out[kind]["reference"])]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.device)
    print(f"device: {args.device}")
    ref = out["float"]["reference"]
    for k, v in out["float"].items():
        print(f"kernel={k:10s} out {tuple(v.shape)} mean "
              f"{v.float().mean().item():.4f} max |diff| against reference "
              f"{(v - ref).abs().max().item()}")
    deq = out["dequantized"]
    print(f"bitpacked chain: {tuple(out['bitpacked']['mxu'].shape)} int32 -> "
          f"bmaxpool2d {tuple(out['pooled'].shape)} -> dequantize "
          f"{tuple(deq.shape)}, values {sorted(deq.unique().tolist())}")
    for k in KERNELS[1:]:
        same = torch.equal(out["bitpacked"][k], out["bitpacked"]["reference"])
        print(f"bitpacked {k} == reference: {same}")
    bad = unequal(out)
    if bad:
        print(f"e2e_smoke: outputs differ from the reference: {bad}",
              file=sys.stderr)
        return 1
    print("e2e_smoke: every lowering equal to the reference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
