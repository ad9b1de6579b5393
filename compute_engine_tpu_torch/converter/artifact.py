"""Packed-model artifact: save/load of converted inference weights.

The reference's persisted artifact is the converted ``.tflite`` flatbuffer
with pre-bitpacked weights (SURVEY.md §5 checkpoint/resume). Ours is a
compressed ``.npz`` holding the packed uint32 filters, fused per-channel
transforms, float-layer kernels, and a JSON header with model name/config —
loadable with zero custom deps.

A numpy-only copy of ``compute_engine_tpu.converter.artifact``: the two
packages read and write the same files.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["save_artifact", "load_artifact", "split_arrays", "merge_arrays"]

_HEADER_KEY = "__header__"


def _flatten(layers):
    flat = {}
    meta = {}
    for lname, layer in layers.items():
        lmeta = {}
        for k, v in layer.items():
            if isinstance(v, np.ndarray):
                flat[f"{lname}/{k}"] = v
            elif v is None:
                lmeta[k] = None
            else:
                lmeta[k] = v
        meta[lname] = lmeta
    return flat, meta


def save_artifact(path, layers, model_name: str, extra_config=None):
    """Write a packed-model artifact (.npz)."""
    flat, meta = _flatten(layers)
    header = {
        "format_version": 1,
        "model": model_name,
        "config": extra_config or {},
        "layer_meta": meta,
    }
    flat[_HEADER_KEY] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **flat)
    return path


def load_artifact(path):
    """Read a packed-model artifact. Returns (model_name, config, layers)."""
    data = np.load(path, allow_pickle=False)
    header = json.loads(bytes(data[_HEADER_KEY]).decode("utf-8"))
    layers = {name: dict(meta) for name, meta in header["layer_meta"].items()}
    for key in data.files:
        if key == _HEADER_KEY:
            continue
        lname, pname = key.rsplit("/", 1)
        layers.setdefault(lname, {})[pname] = data[key]
    return header["model"], header["config"], layers


def split_arrays(layers):
    """Split an artifact into (static_meta, array_tree).

    The array tree holds every non-scalar array (packed filters, transforms,
    float kernels); the static part holds scalars and config.
    ``merge_arrays(static, arrays)`` puts the layer dict back together.
    """
    static, arrays = {}, {}
    for lname, entry in layers.items():
        s, arr = {}, {}
        for k, v in entry.items():
            if getattr(v, "ndim", 0) > 0:
                arr[k] = v
            else:
                s[k] = v
        static[lname] = s
        if arr:
            arrays[lname] = arr
    return static, arrays


def merge_arrays(static, arrays):
    """Inverse of :func:`split_arrays`."""
    merged = {lname: dict(entry) for lname, entry in static.items()}
    for lname, arr in arrays.items():
        merged.setdefault(lname, {}).update(arr)
    return merged
