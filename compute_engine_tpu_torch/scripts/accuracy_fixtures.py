"""Accuracy records of the flagship models at 224x224, trained on the card.

The port of the JAX repo's ``scripts/make_accuracy_fixtures.py``, with its
protocol unchanged: each model is trained briefly on a deterministic
clustered synthetic dataset (STE + Adam, ``models.train_briefly``), its BN
statistics are re-estimated over 16 batches ("precise BN"), and the QAT
float oracle is held against every packed execution path over 512 images at
the production 224x224 input: the packed float32, bfloat16 and true-int8
streams and the packed domain (bitpacked activations chained through
thresholds and the negative-gamma flip). Each record holds the top-1
agreement and the quantiles of the per-image max |prob - oracle prob| of
every path, the oracle's accuracy and its first logits. A path is held
against the oracle at its own operand precision, as on the TPU where the
JAX package's gates were set (``record``), and its agreement with the
float32 oracle is recorded beside.

``train_model`` trains, re-estimates BN and calibrates; ``record`` runs the
forwards, so that parameters trained elsewhere (by the JAX package,
carried across with ``interop.params_from_numpy``) can be recorded too.
``check_record`` holds a record to the JAX package's per-model gates.

Usage (on the card; each model's record is merged into the file):
  python -m compute_engine_tpu_torch.scripts.accuracy_fixtures \\
      [--models quicknet,birealnet18,binary_alexnet,binary_densenet28] \\
      [--out tests/fixtures/torch_accuracy_224.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..interop import layers_from_numpy
from ..models import (calibrate_model, convert_model, float_apply, get_model,
                      init_model, packed_apply, prepare_runtime_arrays,
                      train_briefly)
from ..models.train import (clustered_batch, make_prototypes,
                            recalibrate_bn_stats)

__all__ = ["MODELS", "GATES", "ORACLE_OPERANDS", "train_model", "record", "check_record",
           "run_model", "save_params", "load_params", "main"]

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "tests", "fixtures", "torch_accuracy_224.json")
MODELS = ("quicknet", "birealnet18", "binary_alexnet", "binary_densenet28")
N_EVAL = 512
BATCH = 64
TRAIN_BATCH = 32
# The JAX script's protocol, constant for constant. Classes: separable at
# brief-training scale; the head stays 1000-wide. Bi-RealNet overfits with
# more steps (400 steps measured worse than 250), so it gets 8 classes, not
# more steps; BinaryAlexNet's large STE fc layers converge slowly and get
# 650 steps; the concat topology of BinaryDenseNet-28 needs global-norm
# gradient clipping.
N_CLASSES = {"quicknet": 16, "birealnet18": 8, "binary_alexnet": 8,
             "binary_densenet28": 8}
TRAIN_STEPS = {"quicknet": 250, "birealnet18": 250, "binary_alexnet": 650,
               "binary_densenet28": 250}
CLIP_NORM = {"binary_densenet28": 1.0}
RECAL_BATCHES = 16
# Evaluated on the training distribution: tighter spreads park hidden
# pre-activations near sign boundaries, where a last-bit difference of the
# BN fold flips a sign and the flip cascades.
EVAL_SPREAD = 0.35
ORACLE_MIN = 0.95
PATHS = ("packed_f32", "packed_bf16", "packed_int8", "packed_domain")
# The operand precision of the oracle each path is held against: the
# path's own (``record``).
ORACLE_OPERANDS = {"packed_f32": "float32", "packed_bf16": "bfloat16",
                   "packed_int8": "bfloat16", "packed_domain": "bfloat16"}
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# The JAX package's gates (tests/test_accuracy_fixtures.py): the least top-1
# agreement with the oracle and the largest p99 of the per-image max |dprob|
# of each path. BinaryAlexNet's 4096-wide binary fc tail turns one
# near-threshold sign flip into a large dprob, and its int8 path also
# quantises the fc inputs; BinaryDenseNet-28's int8 path quantises all 23
# growth-feature outputs that feed its concats.
_DEFAULT_GATES = {
    "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                      "packed_int8": 0.99, "packed_domain": 0.99},
    "dprob_p99": {"packed_f32": 0.05, "packed_bf16": 0.3,
                  "packed_int8": 0.5, "packed_domain": 0.3},
}
GATES = {
    "quicknet": _DEFAULT_GATES,
    "birealnet18": _DEFAULT_GATES,
    "binary_alexnet": {
        "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                          "packed_int8": 0.97, "packed_domain": 0.99},
        "dprob_p99": {"packed_f32": 0.5, "packed_bf16": 0.5,
                      "packed_int8": 0.85, "packed_domain": 0.5},
    },
    "binary_densenet28": {
        "min_agreement": {"packed_f32": 0.99, "packed_bf16": 0.99,
                          "packed_int8": 0.85, "packed_domain": 0.99},
        "dprob_p99": {"packed_f32": 0.05, "packed_bf16": 0.3,
                      "packed_int8": 1.0, "packed_domain": 0.3},
    },
}


class Trained(NamedTuple):
    spec: object
    params: dict  # trained numpy parameter tree, BN re-estimated
    protos: np.ndarray
    layers: dict  # the artifact's layers (numpy)
    layers8: dict  # the true-int8 artifact's layers (numpy)
    info: dict  # loss_first, loss_last, seconds_per_step, oracle_accuracy


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_model(name, seed=0, device="cuda", spec=None):
    """Train the zoo model ``name`` (or ``spec``, with ``name``'s protocol)
    by the fixture protocol on ``device``, re-estimate its BN statistics,
    check that the oracle separates the classes (>= 0.95 on 128 images,
    else ``RuntimeError``), and convert it twice: the float artifact and the
    true-int8 one calibrated on one batch of 32."""
    device = resolve_device(device)
    spec = spec or get_model(name)
    n_classes = N_CLASSES[name]
    protos = make_prototypes(1000 + seed, spec.input_size, n_classes)
    _sync(device)
    t0 = time.perf_counter()
    trained, info = train_briefly(
        spec, init_model(spec, seed=seed), steps=TRAIN_STEPS[name],
        batch=TRAIN_BATCH, seed=seed, num_classes=n_classes, protos=protos,
        clip_norm=CLIP_NORM.get(name), device=device)
    _sync(device)
    info = dict(info, seconds_per_step=(time.perf_counter() - t0)
                / TRAIN_STEPS[name])
    recal_rng = np.random.default_rng(4000 + seed)
    trained = recalibrate_bn_stats(
        spec, trained,
        [clustered_batch(protos, recal_rng, BATCH, spread=EVAL_SPREAD)[0]
         for _ in range(RECAL_BATCHES)], device=device)
    # The oracle must separate the classes before agreement means anything.
    xs, ys = clustered_batch(protos, np.random.default_rng(17), 128)
    with torch.no_grad():
        top = float_apply(spec, trained, xs, device=device).argmax(-1)
    acc = float((top.cpu().numpy() == ys).mean())
    info["oracle_accuracy"] = acc
    if acc < ORACLE_MIN:
        raise RuntimeError(
            f"{name}: oracle accuracy {acc:.3f} < {ORACLE_MIN} after "
            f"{TRAIN_STEPS[name]} steps (loss {info['loss_last']:.3f})")
    layers = convert_model(spec, trained)
    in_r, out_r = calibrate_model(
        spec, trained,
        [clustered_batch(protos, np.random.default_rng(3000 + seed),
                         TRAIN_BATCH)[0]], with_outputs=True, device=device)
    layers8 = convert_model(spec, trained, int8_ranges=in_r,
                            int8_out_ranges=out_r)
    return Trained(spec, trained, protos, layers, layers8, info)


def _quantiles(d):
    return {"dprob_p50": round(float(np.percentile(d, 50)), 5),
            "dprob_p99": round(float(np.percentile(d, 99)), 5),
            "dprob_max": round(float(np.max(d)), 5)}


def record(spec, trained, protos, layers, layers8, seed=0, device="cuda",
           train_loss=None):
    """The accuracy record of trained ``spec``: the float oracle against the
    packed float32, bfloat16, true-int8 and packed-domain forwards over
    ``N_EVAL`` images drawn at ``EVAL_SPREAD`` from ``2000 + seed``, in
    batches of ``BATCH``. ``layers``/``layers8`` are the float and int8
    artifacts (numpy); ``train_loss`` is stored as given. The keys and the
    rounding are the JAX script's.

    Each path is held against the oracle whose float convs and dense layers
    take their operands at the path's own precision (``ORACLE_OPERANDS``):
    float32 for ``packed_f32``, bfloat16 for the others. That is the
    comparison the JAX package's TPU records made, where a float32 conv in
    the oracle and in every path rounded its operands to bfloat16 (XLA's
    default precision), and its gates were set on it. Each path also
    records its agreement and dprob p99 against the float32 oracle
    (``exact_oracle``); ``oracle`` is the float32 oracle's, as on the
    JAX package's CPU."""
    device = resolve_device(device)
    run = layers_from_numpy(prepare_runtime_arrays(layers, spec), device)
    run8 = layers_from_numpy(prepare_runtime_arrays(layers8, spec), device)
    forwards = {
        "packed_f32": lambda x: packed_apply(
            spec, run, x, compute_dtype=torch.float32, device=device),
        "packed_bf16": lambda x: packed_apply(spec, run, x, device=device),
        "packed_int8": lambda x: packed_apply(spec, run8, x, device=device),
        "packed_domain": lambda x: packed_apply(spec, run, x, device=device,
                                                domain="packed"),
    }
    rng = np.random.default_rng(2000 + seed)
    agree = {k: 0 for k in forwards}
    agree_exact = {k: 0 for k in forwards}
    dprob = {k: [] for k in forwards}
    dprob_exact = {k: [] for k in forwards}
    oracle_acc, oracle_bf16_acc, first, n = 0, 0, None, 0
    for _ in range(N_EVAL // BATCH):
        x, y = clustered_batch(protos, rng, BATCH, spread=EVAL_SPREAD)
        xd = torch.from_numpy(x).to(device)
        with torch.no_grad():
            want = {dt: float_apply(spec, trained, xd, device=device,
                                    operand_dtype=_DTYPES[dt]).cpu().numpy()
                    for dt in ("float32", "bfloat16")}
        if first is None:
            first = want["float32"][:4, :16]
        top = {dt: w.argmax(-1) for dt, w in want.items()}
        oracle_acc += int((top["float32"] == y).sum())
        oracle_bf16_acc += int((top["bfloat16"] == y).sum())
        for k, fn in forwards.items():
            probs = fn(xd).float().cpu().numpy()
            dt = ORACLE_OPERANDS[k]
            agree[k] += int((probs.argmax(-1) == top[dt]).sum())
            dprob[k].extend(np.abs(probs - want[dt]).max(axis=-1).tolist())
            agree_exact[k] += int((probs.argmax(-1) == top["float32"]).sum())
            dprob_exact[k].extend(
                np.abs(probs - want["float32"]).max(axis=-1).tolist())
        n += BATCH
    return {
        "images": n,
        "paths": {k: {"top1_agreement": agree[k] / n, **_quantiles(dprob[k]),
                      "oracle_operands": ORACLE_OPERANDS[k],
                      "exact_oracle": {
                          "top1_agreement": agree_exact[k] / n,
                          "dprob_p99": _quantiles(dprob_exact[k])[
                              "dprob_p99"]}}
                  for k in forwards},
        "oracle": {"top1_accuracy": oracle_acc / n,
                   "bf16_operands_top1_accuracy": oracle_bf16_acc / n,
                   "first_logits_4x16": np.asarray(first, np.float64)
                   .round(4).tolist()},
        "train_loss": train_loss,
    }


def check_record(name, rec):
    """The failed gates of ``rec`` under ``GATES[name]`` (empty: it meets
    them all): at least ``N_EVAL`` images, oracle top-1 >= 0.95, every path
    of ``PATHS`` present, at its least agreement and under its dprob p99."""
    gates, failed = GATES[name], []
    if rec["images"] < N_EVAL:
        failed.append(f"{name}: {rec['images']} images < {N_EVAL}")
    if rec["oracle"]["top1_accuracy"] < ORACLE_MIN:
        failed.append(f"{name}: oracle top-1 "
                      f"{rec['oracle']['top1_accuracy']} < {ORACLE_MIN}")
    for path in PATHS:
        p = rec["paths"].get(path)
        if p is None:
            failed.append(f"{name}: no {path} path")
            continue
        if p["top1_agreement"] < gates["min_agreement"][path]:
            failed.append(f"{name} {path}: agreement {p['top1_agreement']} "
                          f"< {gates['min_agreement'][path]}")
        if p["dprob_p99"] > gates["dprob_p99"][path]:
            failed.append(f"{name} {path}: dprob p99 {p['dprob_p99']} > "
                          f"{gates['dprob_p99'][path]}")
    return failed


def save_params(path, t):
    """Write the trained tree of ``t`` (a ``Trained``) to ``path`` (.npz),
    keys joined by ``/``. The latent kernels of the binary layers are kept
    as their signs, eight to a byte (``<name>/kernel@signs`` and its shape):
    the oracle and the conversion read nothing else of them, and
    BinaryAlexNet's 58 M binary weights take 7 MB."""
    binary = {n for n, e in t.layers.items() if e["kind"] in ("bconv",
                                                              "bdense")}
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(key + "/", v)
            elif k == "kernel" and prefix[:-1] in binary:
                w = np.asarray(v)
                flat[key + "@signs"] = np.packbits(w.reshape(-1) >= 0)
                flat[key + "@shape"] = np.asarray(w.shape, np.int64)
            else:
                flat[key] = np.asarray(v, np.float32)

    walk("", t.params)
    np.savez(path, **flat)


def load_params(path):
    """The tree ``save_params`` wrote, the binary kernels as +-1 float32
    (sign(0) = +1, as ``ste_sign``)."""
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            if key.endswith("@shape"):
                continue
            value = f[key]
            if key.endswith("@signs"):
                key = key[:-len("@signs")]
                shape = tuple(f[key + "@shape"])
                bits = np.unpackbits(value)[:int(np.prod(shape))]
                value = np.where(bits, 1.0, -1.0).astype(np.float32)
                value = value.reshape(shape)
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def run_model(name, seed=0, device="cuda", save_dir=None):
    """``train_model`` then ``record`` for the zoo model ``name``; the record
    also holds the seconds per training step on ``device``. With
    ``save_dir``, the trained tree goes to ``<save_dir>/<name>.npz``
    (``save_params``)."""
    t = train_model(name, seed=seed, device=device)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        save_params(os.path.join(save_dir, f"{name}.npz"), t)
    rec = record(t.spec, t.params, t.protos, t.layers, t.layers8, seed=seed,
                 device=device,
                 train_loss={k: t.info[k] for k in ("loss_first",
                                                    "loss_last")})
    rec["seconds_per_train_step"] = t.info["seconds_per_step"]
    return rec


def meta(card):
    """The file's ``_meta``: the card (name and power limit, as nvidia-smi
    reports them), torch, CUDA and the recipe."""
    return {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "n_eval": N_EVAL, "n_classes": N_CLASSES, "train_steps": TRAIN_STEPS,
        "clip_norm": CLIP_NORM,
        "recipe": f"train_briefly(steps=TRAIN_STEPS, batch={TRAIN_BATCH}, "
                  "seed=0, clip_norm=CLIP_NORM) on make_prototypes(1000 + "
                  f"seed) clustered data; recalibrate_bn_stats over "
                  f"{RECAL_BATCHES} batches of {BATCH} from 4000 + seed; "
                  f"calibrate_model on one batch of {TRAIN_BATCH} from 3000 "
                  f"+ seed; eval {N_EVAL} images from 2000 + seed at spread "
                  f"{EVAL_SPREAD} in batches of {BATCH} "
                  "(compute_engine_tpu_torch.scripts.accuracy_fixtures)",
    }


def main(argv=None):
    from ..runtime.microbench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", default=",".join(MODELS),
                   help="comma list; each record is merged into --out")
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default="cuda")
    p.add_argument("--save-params", default=None, metavar="DIR",
                   help="also write each trained tree to DIR/<model>.npz")
    args = p.parse_args(argv)
    card = card_line() if torch.device(args.device).type == "cuda" else "cpu"
    try:
        with open(args.out) as f:
            fixtures = json.load(f)
    except (OSError, ValueError):
        fixtures = {}
    fixtures["_meta"] = meta(card)
    failed = []
    for name in args.models.split(","):
        rec = run_model(name, device=args.device, save_dir=args.save_params)
        fixtures[name] = rec
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(fixtures, f, indent=1)
        print(json.dumps({"accuracy_224": {name: rec}}), flush=True)
        print(f"{name}: {rec['seconds_per_train_step']:.4f} s per training "
              f"step [{card}]", flush=True)
        failed += check_record(name, rec)
    print("wrote", args.out, flush=True)
    if failed:
        raise SystemExit("gates missed: " + "; ".join(failed))


if __name__ == "__main__":
    main()
