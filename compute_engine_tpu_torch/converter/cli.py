"""Converter CLI: counterpart of LCE's `tests/convert_model.py` manual
conversion harness and its `convert_keras_model` entry point; the port of
``compute_engine_tpu.converter.cli``. An artifact written by either
package's CLI loads in either package.

Usage:
  python -m compute_engine_tpu_torch.converter.cli --model quicknet \\
      --output q.npz
      [--keras-h5 model.h5 | --keras-saved-model dir]   # import weights
      [--seed 0]                                        # else random init
      [--int8-calib-batches 4]                          # int8 model
      [--device cuda]                                   # for calibration

``--model auto`` with a Keras source walks the Keras graph directly
(converter.graph_import), with no registry spec, and stores the graph program
in the artifact's header, which makes the artifact self-contained.

Conversion itself is numpy and needs no card. ``--int8-calib-batches`` runs
the float layers over random batches on ``--device`` (the card unless
``cpu`` is asked for; without a card it raises).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--keras-h5", default=None)
    p.add_argument("--keras-saved-model", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8-calib-batches", type=int, default=0,
                   help="if >0, calibrate on N random batches and emit an "
                        "int8 artifact")
    p.add_argument("--device", default="cuda",
                   help="where calibration runs the float layers")
    args = p.parse_args(argv)

    from ..models import (calibrate_model, convert_model, get_model,
                          init_model)
    from .artifact import save_artifact

    graph_program = None
    if args.model == "auto":
        if not (args.keras_h5 or args.keras_saved_model):
            p.error("--model auto requires a --keras-h5/--keras-saved-model "
                    "source to walk")
        import tensorflow as tf

        from .graph_import import import_keras_model

        keras_model = tf.keras.models.load_model(
            args.keras_h5 or args.keras_saved_model)
        spec, params = import_keras_model(keras_model)
        graph_program = spec.forward.program
        source = args.keras_h5 or args.keras_saved_model
    elif args.keras_h5 or args.keras_saved_model:
        import tensorflow as tf

        from .keras_import import import_keras_weights

        spec = get_model(args.model)
        keras_model = (tf.keras.models.load_model(args.keras_h5)
                       if args.keras_h5 else
                       tf.keras.models.load_model(args.keras_saved_model))
        params = import_keras_weights(keras_model, spec)
        source = args.keras_h5 or args.keras_saved_model
    else:
        spec = get_model(args.model)
        params = init_model(spec, seed=args.seed, randomize_bn=True)
        source = f"random(seed={args.seed})"

    int8_ranges = int8_out_ranges = None
    if graph_program is not None:
        # QAT graphs carry their own quantizer ranges, absorbed by the
        # importer (graph_int8_ranges): no calibration needed
        # (`mlir/transforms/quantize.cc:15-42` analogue).
        from .graph_import import graph_int8_ranges

        g_in, g_out = graph_int8_ranges(spec)
        if g_in or g_out:
            int8_ranges, int8_out_ranges = g_in or None, g_out or None
    if args.int8_calib_batches:
        rng = np.random.default_rng(args.seed)
        batches = [rng.normal(0, 1, (4, *spec.input_size, 3)).astype(
            np.float32) for _ in range(args.int8_calib_batches)]
        int8_ranges, int8_out_ranges = calibrate_model(
            spec, params, batches, with_outputs=True, device=args.device)

    layers = convert_model(spec, params, int8_ranges=int8_ranges,
                           int8_out_ranges=int8_out_ranges)
    extra = {
        "source": source,
        "int8": bool(int8_ranges),
        "input_size": list(spec.input_size),
        "num_classes": spec.num_classes,
    }
    if graph_program is not None:
        extra["graph_program"] = graph_program
    save_artifact(args.output, layers, spec.name, extra)
    n_bin = sum(1 for l in layers.values() if l["kind"] in ("bconv", "bdense"))
    packed_bytes = sum(
        l["packed_filter"].nbytes if "packed_filter" in l else
        l.get("packed_kernel", np.empty(0)).nbytes
        for l in layers.values() if l["kind"] in ("bconv", "bdense"))
    print(json.dumps({
        "model": spec.name, "output": args.output, "layers": len(layers),
        "binary_layers": n_bin, "packed_weight_bytes": int(packed_bytes),
        "int8": bool(int8_ranges),
    }))


if __name__ == "__main__":
    main()
