"""The accuracy protocol's forwards on one set of trained parameters, through
the JAX package and through the port, image by image, on the CPU.

``accuracy_fixtures --save-params DIR`` writes the tree a card trained; this
script draws the record's 512 images (``2000 + seed``), runs the JAX
package's float oracle and its packed float32, bfloat16 and packed-domain
forwards on them, the port's same four forwards, and one more oracle: the
JAX oracle with the operands of its float convs and dense layers rounded to
bfloat16 and summed in float32, which is what a float32 conv or matmul at
XLA's default precision computes on a TPU. It prints, as one JSON object,
each path's top-1 agreement with each oracle, the images where they
disagree, and whether the two packages give the same top-1 on every image.

Usage (JAX on the CPU; about 15 min for BinaryAlexNet on 8 cores):
  JAX_PLATFORMS=cpu python tests/crosscheck_accuracy_record.py \\
      --params params/binary_alexnet.npz [--model binary_alexnet]
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import compute_engine_tpu.models.layers as JL  # noqa: E402
from compute_engine_tpu.models import convert_model as jconvert  # noqa: E402
from compute_engine_tpu.models import float_apply as jfloat_apply  # noqa: E402
from compute_engine_tpu.models import get_model as jget_model  # noqa: E402
from compute_engine_tpu.models import packed_apply as jpacked_apply  # noqa: E402
from compute_engine_tpu.models import (  # noqa: E402
    prepare_runtime_arrays as jprepare)
from compute_engine_tpu_torch.interop import (  # noqa: E402
    layers_from_numpy, params_from_numpy)
from compute_engine_tpu_torch.models import (  # noqa: E402
    convert_model, float_apply, get_model, packed_apply,
    prepare_runtime_arrays)
from compute_engine_tpu_torch.models.train import (  # noqa: E402
    clustered_batch, make_prototypes)
from compute_engine_tpu_torch.scripts import accuracy_fixtures as af  # noqa: E402

PATHS = ("packed_f32", "packed_bf16", "packed_domain")


@contextlib.contextmanager
def bf16_operands():
    """JAX's float convs and dense layers with bfloat16-rounded operands and
    float32 sums: a float32 conv at XLA's default precision on a TPU."""
    conv, depthwise, dense = JL.conv2d, JL.depthwise_conv2d, JL.dense

    def round_(a):
        return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)

    JL.conv2d = lambda x, k, *a, **kw: conv(round_(x), round_(k), *a, **kw)
    JL.depthwise_conv2d = lambda x, k, *a, **kw: depthwise(
        round_(x), round_(k), *a, **kw)
    JL.dense = lambda x, k, b=None: dense(round_(x), round_(k), b)
    try:
        yield
    finally:
        JL.conv2d, JL.depthwise_conv2d, JL.dense = conv, depthwise, dense


def crosscheck(name, params, seed=0):
    jspec, spec = jget_model(name), get_model(name)
    protos = make_prototypes(1000 + seed, spec.input_size,
                             af.N_CLASSES[name])
    jlayers = jconvert(jspec, params)
    run = layers_from_numpy(prepare_runtime_arrays(convert_model(spec,
                                                                 params)))
    jrun = jprepare(jlayers)
    tparams = params_from_numpy(params)
    jdt = {"packed_f32": jnp.float32, "packed_bf16": jnp.bfloat16,
           "packed_domain": jnp.bfloat16}
    tdt = {"packed_f32": torch.float32, "packed_bf16": torch.bfloat16,
           "packed_domain": torch.bfloat16}
    top = {}

    def add(key, probs):
        top.setdefault(key, []).extend(np.asarray(probs, np.float32)
                                       .argmax(-1).tolist())

    rng = np.random.default_rng(2000 + seed)
    for b in range(af.N_EVAL // af.BATCH):
        x, _ = clustered_batch(protos, rng, af.BATCH, spread=af.EVAL_SPREAD)
        xj = jnp.asarray(x)
        add("jax/oracle", jfloat_apply(jspec, params, xj))
        with bf16_operands():
            add("jax/oracle_bf16_operands", jfloat_apply(jspec, params, xj))
        with torch.no_grad():
            add("port/oracle", float_apply(spec, tparams, x, device="cpu"))
        for path in PATHS:
            domain = "packed" if path == "packed_domain" else "float"
            add(f"jax/{path}", jpacked_apply(
                jspec, jrun, xj, kernel="mxu", compute_dtype=jdt[path],
                domain=domain))
            add(f"port/{path}", packed_apply(
                spec, run, x, compute_dtype=tdt[path], device="cpu",
                domain=domain).float().numpy())
        print(f"  {(b + 1) * af.BATCH}/{af.N_EVAL}", file=sys.stderr,
              flush=True)
    top = {k: np.asarray(v) for k, v in top.items()}
    out = {"model": name, "images": af.N_EVAL, "agreement": {},
           "disagree": {}, "same_top1_jax_port": {}}
    for lib in ("jax", "port"):
        oracles = ["oracle"] + (["oracle_bf16_operands"] if lib == "jax"
                                else [])
        for o in oracles:
            ref = top[f"{lib}/{o}"]
            for path in PATHS:
                key = f"{lib}/{path} vs {lib}/{o}"
                miss = np.flatnonzero(top[f"{lib}/{path}"] != ref)
                out["agreement"][key] = 1 - len(miss) / len(ref)
                out["disagree"][key] = miss.tolist()
    for k in ("oracle",) + PATHS:
        out["same_top1_jax_port"][k] = bool(
            np.array_equal(top[f"jax/{k}"], top[f"port/{k}"]))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--params", required=True)
    p.add_argument("--model", default="binary_alexnet")
    args = p.parse_args()
    print(json.dumps(crosscheck(args.model, af.load_params(args.params))))


if __name__ == "__main__":
    main()
