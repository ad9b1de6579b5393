"""Kernel selection for binary convolutions and binary dense layers.

The port of ``compute_engine_tpu.kernels.select``. The choice is between
whole lowerings of one layer, each exact:

  float input (the model runtime's stream between layers):
    "residual"  the fused block kernel (``kernels/residual.py``), where it
                applies: 3x3, stride 1, undilated, ungrouped, SAME one or
                zero padding; fused with the residual add when the layer's
                consumer is that add
    "bgemm"     quantize (pack), then the binary GEMM kernel
    "mxu"       sign to +-1 int8 and the exact integer conv
                (``bconv2d_mxu_float_in``)
    "s2d"       the same after a space-to-depth(2) retile
                (``bconv2d_mxu_s2d``)

  packed input (uint32 words; the packed domain):
    "bgemm"     the binary GEMM kernel on the packed im2col
    "mxu"       unpack to +-1 int8 and the exact integer conv

A binary dense layer is the ``fh = fw = 1`` entry of the same table with
``m = batch``; its "mxu" is the +-1 int8 product.

Selection is a pure function of the static shape. A table entry maps a
key to the winner per layer geometry (stride, padding kind, dilation,
groups; ``_geometry``): the key scheme is the JAX package's, which leaves
the geometry out, and a lowering measured at one stride or padding says
nothing of another (a zero-padded conv pays a correction that a one-padded
one does not). Lookup order: the exact measured key at the layer's
geometry, then the measured bucket key (``_bucket_key``) at it, then
``_heuristic``. The built-in table is ``kernel_table_h100.json``, measured on
an H100 by ``python -m compute_engine_tpu_torch.kernels.autotune`` (its
``_meta`` names the card, its power limit and the software);
``autotune_bconv2d`` and ``autotune_bdense`` re-measure on the current card
and override it in the process. The key scheme is the JAX package's, letter
for letter; no winner measured on a TPU is carried over.
"""

from __future__ import annotations

import json
import math
import os

from ..core.params import BConv2DParams
from ..core.types import Padding, packed_size
from .bgemm import uses_split_k
from .residual import residual_block_supported

__all__ = ["select_bconv2d_kernel", "autotune_bconv2d", "autotune_bdense",
           "measured_entry_tier", "kernel_table", "load_table", "save_table",
           "reset_table", "residual_applies", "s2d_applies", "layer_kwargs",
           "layer_lowering", "layer_launches", "CANDIDATES"]

# Every lowering the table may name, by domain.
CANDIDATES = {"float": ("residual", "bgemm", "mxu", "s2d"),
              "packed": ("bgemm", "mxu")}


def _m_bucket(m: int) -> int:
    """log2 bucket of the GEMM row count (batch * out_h * out_w)."""
    return max(0, int(math.log2(max(m, 1))))


def _c_bucket(c: int) -> int:
    """log2 bucket of a channel count (the bucket-tier key coordinate)."""
    return max(0, int(math.log2(max(c, 1))))


def _f_coord(fh: int, fw: int):
    """Filter coordinate of a table key: the area for square filters and an
    "FHxFW" string for rectangular ones, so 1x9 and 3x3 cannot collide on
    equal area."""
    return fh * fw if fh == fw else f"{fh}x{fw}"


def _key(domain: str, c_in: int, c_out: int, fhw, m: int,
         out_kind: str) -> tuple:
    return (domain, c_in, c_out, fhw, _m_bucket(m), out_kind)


def _bucket_key(domain: str, c_in: int, c_out: int, fhw, m: int,
                out_kind: str) -> tuple:
    """Measured-generalisation tier: exact channel counts collapse to log2
    buckets, so one measured representative covers every shape of its
    bucket. Exact keys always take precedence."""
    return ("b", domain, _c_bucket(c_in), _c_bucket(c_out), fhw,
            _m_bucket(m), out_kind)


def _geometry(stride=(1, 1), padding: str = "SAME", pad_value: int = 1,
              dilation=(1, 1), groups: int = 1) -> str:
    """The geometry a table entry was measured at, beside its key: the
    stride, the padding kind ("one", "zero" or "valid"), and the dilation
    and groups where they are not 1. A binary dense is "s1/valid"."""
    sh, sw = tuple(stride)
    parts = [f"s{sh}" if sh == sw else f"s{sh}x{sw}",
             "valid" if padding == "VALID"
             else ("one" if pad_value == 1 else "zero")]
    if tuple(dilation) != (1, 1):
        parts.append("d{}x{}".format(*dilation))
    if groups != 1:
        parts.append(f"g{groups}")
    return "/".join(parts)


_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                           "kernel_table_h100.json")


def _parse_key(k: str) -> tuple:
    parts = k.split("|")
    if parts[0] == "b":  # bucket-tier key
        _, domain, cinb, coutb, fhw, mb, out_kind = parts
        return ("b", domain, int(cinb), int(coutb),
                fhw if "x" in fhw else int(fhw), int(mb), out_kind)
    domain, c_in, c_out, fhw, mb, out_kind = parts
    return (domain, int(c_in), int(c_out),
            fhw if "x" in fhw else int(fhw), int(mb), out_kind)


def _entries(data: dict) -> dict:
    """Table entries of a JSON object: key -> {geometry: winner}."""
    return {_parse_key(k): dict(v) for k, v in data.items()
            if not k.startswith("_")}


def _load_default_table() -> dict:
    try:
        with open(_TABLE_PATH) as f:
            return _entries(json.load(f))
    except (OSError, ValueError, TypeError):
        return {}  # a missing or malformed table must not take down import


_DEFAULT_TABLE: dict[tuple, dict[str, str]] = _load_default_table()

_TABLE: dict[tuple, dict[str, str]] = {k: dict(v)
                                       for k, v in _DEFAULT_TABLE.items()}


def kernel_table() -> dict:
    """The process table: key -> {geometry: winner}."""
    return _TABLE


def _lookup(key: tuple, geo: str):
    return _TABLE.get(key, {}).get(geo)


def measured_entry_tier(domain: str, *, c_in: int, c_out: int, fh: int,
                        fw: int, m: int, out_kind: str = "float",
                        groups: int = 1, dilation=(1, 1), stride=(1, 1),
                        padding: str = "SAME", pad_value: int = 1) -> str:
    """Which measured tier covers this layer: "exact", "bucket", or ""
    (the heuristic)."""
    fc = _f_coord(fh, fw)
    geo = _geometry(stride, padding, pad_value, dilation, groups)
    if _lookup(_key(domain, c_in, c_out, fc, m, out_kind), geo):
        return "exact"
    if _lookup(_bucket_key(domain, c_in, c_out, fc, m, out_kind), geo):
        return "bucket"
    return ""


def reset_table() -> None:
    _TABLE.clear()
    _TABLE.update({k: dict(v) for k, v in _DEFAULT_TABLE.items()})


def load_table(path: str) -> None:
    with open(path) as f:
        for key, by_geo in _entries(json.load(f)).items():
            _TABLE.setdefault(key, {}).update(by_geo)


def save_table(path: str, meta: dict | None = None) -> None:
    """Write the process table; ``meta`` goes under ``_meta``."""
    data = {"|".join(str(p) for p in k): v for k, v in _TABLE.items()}
    if meta is not None:
        data["_meta"] = meta
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def residual_applies(domain: str, *, fh: int, fw: int, c_in: int,
                     groups: int = 1, dilation=(1, 1), stride=(1, 1),
                     padding: str = "SAME", pad_value: int = 1) -> bool:
    """Whether the block kernel can run this layer: the float domain and
    ``kernels.residual.residual_block_supported`` without the residual
    add's channel condition."""
    params = BConv2DParams(
        channels_in=c_in, stride=tuple(stride), dilation=tuple(dilation),
        padding=Padding.SAME if padding == "SAME" else Padding.VALID,
        pad_value=pad_value, groups=groups)
    return domain == "float" and residual_block_supported(
        (c_in,), params, c_in, fh, fw, has_residual=False)


def s2d_applies(domain: str, *, c_in: int, groups: int = 1,
                dilation=(1, 1), stride=(1, 1)) -> bool:
    """Whether the space-to-depth retile can run this layer."""
    return (domain == "float" and groups == 1 and tuple(dilation) == (1, 1)
            and stride[0] == stride[1] and stride[0] in (1, 2)
            and c_in % 2 == 0)


def _heuristic(domain: str, out_kind: str, residual_ok: bool,
               zero_pad: bool, stride, m: int) -> str:
    """The choice where the table has no entry at the layer's geometry,
    from the regularities of the H100 measurements
    (``kernel_table_h100.json``'s ``raw_ms``; PERF.md §6, rows named
    below):

      * float domain, the block kernel applies (3x3, stride 1, one or zero
        padding): "residual". One-padded, it won at every measured shape
        but one (DenseNet's 14x14x1024 -> 64 at batch 1, within 0.005 ms),
        at batch 128 by 5 to 25 times the next lowering (PERF.md row
        "float, 3x3 one-padded, stride 1"); zero-padded, at every one of
        Bi-RealNet's convs at batch 1, 8 and 128, at batch 128 by 5 to 15
        times (0.093 against 1.36 ms for the GEMM at 56x56x64, 0.049
        against 0.242 for "mxu" at 7x7x512; ``raw_ms``).
      * float domain, zero padding, stride 2: "mxu", which won at every
        measured one (Bi-RealNet's transitions; 0.81 against 0.93 ms for
        the GEMM at 56x56x64 -> 128, batch 128; PERF.md row "float,
        zero-padded, stride 2").
      * float domain, zero padding, stride 1 where the block kernel does
        not apply: "bgemm" from 2**15 GEMM rows up, "mxu" below (measured
        on Bi-RealNet's 3x3 convs before the block kernel took zero
        padding: the GEMM won at 56x56 and 28x28, batch 128, 1.32 and 0.72
        ms against 1.73 and 0.88; "mxu" won every batch-1 and batch-8 cell
        and 7x7 at batch 128).
      * everywhere else: "bgemm", which won at every one-padded stride-2
        conv, the 5x5 conv, every binary dense and every packed-domain
        shape (PERF.md rows "float, 3x3 one-padded, stride 2", "float, 5x5
        and dense" and "packed").

    With no measurement at all this is what "auto" ran before the table
    at every one-padded conv: the block kernel where it applies, the binary
    GEMM elsewhere.
    """
    if domain == "float" and out_kind == "float":
        if residual_ok:
            return "residual"
        if zero_pad and (tuple(stride) != (1, 1) or m < 2 ** 15):
            return "mxu"
    return "bgemm"


def select_bconv2d_kernel(domain: str, *, c_in: int, c_out: int, fh: int,
                          fw: int, m: int, out_kind: str = "float",
                          groups: int = 1, dilation=(1, 1), stride=(1, 1),
                          padding: str = "SAME", pad_value: int = 1) -> str:
    """Pick the lowering of a binary conv (or dense: fh = fw = 1, VALID)
    with the given static shape.

    Args:
      domain: "packed" (words in) or "float" (float activations in).
      m: GEMM rows = batch * out_h * out_w.
      padding, pad_value: the layer's padding ("SAME"/"VALID", 1 or 0);
        with the stride, dilation and groups they are the geometry that a
        table entry must have been measured at to decide this layer.

    Returns a name of ``CANDIDATES[domain]``. "s2d" where the retile cannot
    run gives "mxu", as in the JAX package: a constraint decided from the
    shape before anything runs.
    """
    fc = _f_coord(fh, fw)
    geo = _geometry(stride, padding, pad_value, dilation, groups)
    choice = (_lookup(_key(domain, c_in, c_out, fc, m, out_kind), geo)
              or _lookup(_bucket_key(domain, c_in, c_out, fc, m, out_kind),
                         geo))
    if choice is None:
        residual_ok = residual_applies(
            domain, fh=fh, fw=fw, c_in=c_in, groups=groups,
            dilation=dilation, stride=stride, padding=padding,
            pad_value=pad_value)
        choice = _heuristic(domain, out_kind, residual_ok,
                            padding == "SAME" and pad_value == 0, stride, m)
    if choice == "s2d" and not s2d_applies(domain, c_in=c_in, groups=groups,
                                           dilation=dilation, stride=stride):
        return "mxu"
    return choice


def layer_kwargs(layer: dict) -> dict:
    """The static shape of a binary layer as ``select_bconv2d_kernel``'s
    keywords, every one given. ``layer`` is a record of ``models.shapes`` or
    a dict with the same fields: a conv's ``c_in``, ``c_out``, ``fh``,
    ``fw``, ``m`` and optionally ``stride``, ``padding``, ``pad_value``,
    ``groups`` and ``dilation``; a dense's ``c_in``, ``units`` and ``m``
    (a 1x1 VALID conv)."""
    if "units" in layer:
        layer = dict(layer, c_out=layer["units"], fh=1, fw=1,
                     padding="VALID")
    kw = dict(stride=(1, 1), padding="SAME", pad_value=1, groups=1,
              dilation=(1, 1))
    kw.update((k, layer[k]) for k in (*kw, "c_in", "c_out", "fh", "fw", "m")
              if k in layer)
    return kw


def layer_lowering(kernel: str, layer: dict, domain: str = "float",
                   out_kind: str = "float", float_in: bool = True) -> str:
    """The lowering that runs one binary layer (see ``layer_kwargs``) under
    the model runtime's ``kernel=``: "residual", "bgemm", "mxu", "s2d" or
    "reference". ``PackedBuilder`` and ``ops.bconv2d`` dispatch on it, and
    launch counts are predicted from it (``layer_launches``).

      "auto"       the table's choice at this shape and geometry
      "residual"   the block kernel where it can run, the table elsewhere
      "bgemm", "mxu", "s2d", "reference"
                   that lowering ("s2d" gives "mxu" where the retile cannot
                   run)

    A binary dense has "mxu" and "bgemm" only: "reference" runs the GEMM
    and the float lowerings' names mean "mxu" (as in the JAX package). In
    the packed domain "residual" and "s2d" mean "auto". A binary conv with
    int8 output takes the GEMM's int8 epilogue whatever ``kernel`` says, and
    one whose input is not floating point (``float_in``: int8 values) takes
    no block kernel.
    """
    kw = layer_kwargs(layer)
    dense = "units" in layer
    k = kernel
    if domain == "packed" and k in ("residual", "s2d"):
        k = "auto"
    if dense:
        if k in ("residual", "s2d"):
            k = "mxu"
        elif k == "auto":
            k = select_bconv2d_kernel(domain, out_kind=out_kind, **kw)
        return "mxu" if k == "mxu" else "bgemm"
    if out_kind == "int8":
        return "bgemm"
    block_ok = float_in and residual_applies(
        domain, fh=kw["fh"], fw=kw["fw"], c_in=kw["c_in"],
        groups=kw["groups"], dilation=kw["dilation"], stride=kw["stride"],
        padding=kw["padding"], pad_value=kw["pad_value"])
    if k == "auto" or (k == "residual" and not block_ok):
        k = select_bconv2d_kernel(domain, out_kind=out_kind, **kw)
    if k == "residual":
        return "residual" if block_ok else "bgemm"
    if k == "s2d" and not s2d_applies(
            domain, c_in=kw["c_in"], groups=kw["groups"],
            dilation=kw["dilation"], stride=kw["stride"]):
        return "mxu"
    return k


def layer_launches(lowering: str, layer: dict) -> tuple[int, int, int]:
    """(block, GEMM, split-K) kernel launches that ``lowering`` makes for
    one binary layer: the block kernel once for "residual"; for "bgemm" one
    GEMM per group, split over K where a group's packed depth exceeds the
    GEMM's one-pass limit (``kernels.bgemm.uses_split_k``); none for the
    library lowerings."""
    if lowering == "residual":
        return (1, 0, 0)
    if lowering != "bgemm":
        return (0, 0, 0)
    kw = layer_kwargs(layer)
    groups = kw["groups"]
    depth = packed_size(kw["c_in"] // groups) * kw["fh"] * kw["fw"]
    return (0, 0, groups) if uses_split_k(depth) else (0, groups, 0)


def _norm_shape(s):
    """An autotune shape: an (h, w, c_in, c_out, fh) tuple or a dict with
    optional ``fw``, ``stride``, ``pad_value`` and ``padding``, as a
    canonical dict."""
    if isinstance(s, dict):
        d = dict(s)
    else:
        h, w, c_in, c_out, fh = s
        d = {"h": h, "w": w, "c_in": c_in, "c_out": c_out, "fh": fh}
    d.setdefault("fw", d["fh"])
    d.setdefault("stride", (1, 1))
    if isinstance(d["stride"], int):
        d["stride"] = (d["stride"], d["stride"])
    d["stride"] = tuple(d["stride"])
    d.setdefault("pad_value", 1)
    d.setdefault("padding", "SAME")
    return d


# The exactness gate's tolerance for float output: one FMA rounding of the
# epilogue (``kernels/residual.py``: the port's epilogues round the product
# and the sum separately, so on one card they agree bit for bit), seen
# through one more rounding to bfloat16 where the output is stored in it.
FLOAT32_GATE = dict(rtol=2e-5, atol=2e-4)
BFLOAT16_GATE = dict(rtol=1.6e-2, atol=0.5)


def _same_output(got, want) -> bool:
    """The exactness gate: ``torch.equal`` for int8 and bitpacked words,
    the FMA tolerance for float."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    tol = FLOAT32_GATE if got.dtype == torch.float32 else BFLOAT16_GATE
    return bool(torch.allclose(got.float(), want.float(), **tol))


def _gate(per_outputs, anchor, label):
    """Hold every candidate's output against the anchor's (the "bgemm"
    lowering's); raise, naming the candidate, if one differs."""
    want = per_outputs[anchor]
    for key, got in per_outputs.items():
        if not _same_output(got, want):
            raise RuntimeError(
                f"autotune {label}: {'/'.join(key)} differs from "
                f"{'/'.join(anchor)}; it may not be recorded")


def _measure(fn, args, iters):
    from ..runtime import microbench  # looked up at call time (tests stub it)

    return microbench.time_fn(fn, args, iters=iters)


def _record(per, key_of, geo, record_bucket):
    for domain in ("packed", "float"):
        cands = {kn: t for (d2, kn), t in per.items() if d2 == domain}
        if not cands:
            continue
        winner = min(cands, key=cands.get)
        key, bucket = key_of(domain)
        _TABLE.setdefault(key, {})[geo] = winner
        if record_bucket:
            _TABLE.setdefault(bucket, {})[geo] = winner


def _on(v, device):
    import torch

    return torch.as_tensor(v).to(device)


def autotune_bconv2d(shapes, *, batch=8, out_kind="float", iters=20,
                     pad_value=None, update_table=True, record_bucket=False,
                     candidates=None, device="cuda", dtype=None):
    """Measure every candidate lowering per shape on ``device`` (the card
    by default) and record the winners.

    ``shapes``: (h, w, c_in, c_out, fh) tuples or dicts (see
    ``_norm_shape``). Each candidate runs the layer as the model runtime
    runs it: float-domain candidates take activations in ``dtype`` (the
    activation stream's, bfloat16 by default) and store their output in it;
    where the block kernel fuses the residual add (c_in == c_out and the
    block applies) every float-domain rival adds the residual too. Before
    anything is timed, every candidate's output must equal the "bgemm"
    lowering's (``torch.equal`` for int8 and bitpacked output, the FMA
    tolerance for float), or this raises.

    ``candidates``: optional subset of "domain/name" strings. Returns
    {shape_key: {(domain, name): seconds}}; with ``update_table`` the winner
    of each measured domain is recorded under the exact key, and with
    ``record_bucket`` also under the bucket key.
    """
    import numpy as np
    import torch

    from ..core.bitpack import bitpack, bitunpack
    from ..core.params import BConv2DParams
    from ..core.reference import zero_padding_tap_delta
    from ..core.transforms import (OutputTransform, compute_output_thresholds,
                                   fuse_output_transform)
    from ..core.types import Padding
    from ..device import resolve_device
    from ..ops import bconv2d as bconv2d_op
    from ..ops import quantize
    from .bconv2d import bconv2d_mxu_float_in, bconv2d_mxu_s2d
    from .residual import binary_residual_block

    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    rng = np.random.default_rng(0)
    results = {}
    for shape in shapes:
        d = _norm_shape(shape)
        if pad_value is not None:
            d["pad_value"] = pad_value
        h, w, c_in, c_out = d["h"], d["w"], d["c_in"], d["c_out"]
        fh, fw = d["fh"], d["fw"]
        params = BConv2DParams(
            channels_in=c_in, stride=d["stride"],
            padding=Padding.SAME if d["padding"] == "SAME" else Padding.VALID,
            pad_value=d["pad_value"])
        k = fh * fw * c_in
        post_mul = rng.uniform(0.1, 2.0, c_out).astype(np.float32)
        post_bias = rng.uniform(-5, 5, c_out).astype(np.float32)
        if out_kind == "bitpacked":
            tr = OutputTransform(thresholds=_on(compute_output_thresholds(
                post_mul, post_bias, k), device))
        else:
            t = fuse_output_transform(post_mul, post_bias, k)
            tr = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                                 multiplier=_on(t.multiplier, device),
                                 bias=_on(t.bias, device))
        xf = torch.from_numpy(rng.normal(0, 1, (batch, h, w, c_in)).astype(
            np.float32)).to(device, dtype)
        xp = quantize(xf)
        wp = bitpack(torch.from_numpy(rng.choice(
            [-1.0, 1.0], size=(c_out, fh, fw, c_in)).astype(np.float32))
            .to(device))
        # The +-1 filter unpacked once, and zero padding's correction table
        # made once, as the model runtime holds them.
        w_pm1 = bitunpack(wp, c_in, dtype=torch.int8).permute(1, 2, 3, 0)
        delta = (zero_padding_tap_delta(wp, params)
                 if params.pad_value == 0 else None)
        block = (out_kind == "float" and residual_applies(
            "float", fh=fh, fw=fw, c_in=c_in, stride=d["stride"],
            padding=d["padding"], pad_value=d["pad_value"]))
        fused = block and c_in == c_out

        def stored(y, x):
            """A float-domain output as the runtime keeps it."""
            if out_kind != "float":
                return y
            y = y.to(dtype)
            return x + y if fused else y

        runners = {
            ("packed", "bgemm"): lambda xp, wp: bconv2d_op(
                xp, wp, tr, params, out_kind, kernel="bgemm"),
            # The packed domain's bitpacked output reads the sign-flipped
            # filter, which the runtime holds packed only.
            ("packed", "mxu"): lambda xp, wp: bconv2d_op(
                xp, wp, tr, params, out_kind, kernel="mxu",
                unpacked_filter=None if out_kind == "bitpacked" else w_pm1),
        }
        if block:
            runners[("float", "residual")] = lambda xf, wp: (
                binary_residual_block(xf, wp, tr, params, has_residual=fused,
                                      unpacked_filter=w_pm1,
                                      tap_delta=delta))
        runners[("float", "mxu")] = lambda xf, wp: stored(
            bconv2d_mxu_float_in(xf, wp, tr, params, out_kind,
                                 unpacked_filter=w_pm1), xf)
        runners[("float", "bgemm")] = lambda xf, wp: stored(
            bconv2d_op(quantize(xf), wp, tr, params, out_kind,
                       kernel="bgemm"), xf)
        if s2d_applies("float", c_in=c_in, stride=d["stride"]):
            runners[("float", "s2d")] = lambda xf, wp: stored(
                bconv2d_mxu_s2d(xf, wp, tr, params, out_kind,
                                unpacked_filter=w_pm1), xf)
        chosen = {key: run for key, run in runners.items()
                  if candidates is None or "/".join(key) in candidates}
        args = {"packed": (xp, wp), "float": (xf, wp)}
        skey = (h, w, c_in, c_out, fh,
                *(() if fw == fh else (fw,)),
                *(() if d["stride"] == (1, 1) and d["pad_value"] == 1
                  else (d["stride"][0], d["pad_value"])))
        for domain in ("packed", "float"):
            outs = {key: run(*args[domain]) for key, run in chosen.items()
                    if key[0] == domain}
            if outs:
                anchor = (domain, "bgemm")
                if anchor not in outs:
                    outs[anchor] = runners[anchor](*args[domain])
                _gate(outs, anchor, f"{skey} {domain} {out_kind}")
        per = {key: _measure(run, args[key[0]], iters)
               for key, run in chosen.items()}
        results[skey] = per
        if update_table:
            out_h, out_w, _, _ = params.output_spatial(h, w, fh, fw)
            m = batch * out_h * out_w
            fc = _f_coord(fh, fw)
            _record(per, lambda dom: (
                _key(dom, c_in, c_out, fc, m, out_kind),
                _bucket_key(dom, c_in, c_out, fc, m, out_kind)),
                _geometry(d["stride"], d["padding"], d["pad_value"]),
                record_bucket)
    return results


def autotune_bdense(shapes, *, batch=8, iters=20, update_table=True,
                    record_bucket=False, candidates=None, out_kind="float",
                    device="cuda", dtype=None):
    """Measure binary-dense candidates per (c_in, units): "mxu" (the +-1
    int8 product) and "bgemm" (the binary GEMM), each in the float domain
    (float activations in, the stream's ``dtype`` out) and in the packed
    domain (packed words in). The same exactness gate as
    ``autotune_bconv2d`` holds before anything is timed. Winners are
    recorded under the ``fh = fw = 1``, ``m = batch`` key of ``out_kind``.
    """
    import numpy as np
    import torch

    from ..core.bitpack import bitpack, bitunpack
    from ..core.transforms import (OutputTransform, compute_output_thresholds,
                                   fuse_output_transform)
    from ..device import resolve_device
    from ..ops import quantize
    from .bconv2d import bdense_mxu, bdense_mxu_float_in
    from .bgemm import bgemm

    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    rng = np.random.default_rng(0)
    results = {}
    for (c_in, units) in shapes:
        post_mul = rng.uniform(0.1, 2.0, units).astype(np.float32)
        post_bias = rng.uniform(-5, 5, units).astype(np.float32)
        if out_kind == "bitpacked":
            thr = _on(compute_output_thresholds(post_mul, post_bias, c_in),
                      device)
            tr = OutputTransform(thresholds=thr)
            gemm_out = dict(thresholds=thr, out_kind="bitpacked")
        else:
            t = fuse_output_transform(post_mul, post_bias, c_in)
            tr = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                                 multiplier=_on(t.multiplier, device),
                                 bias=_on(t.bias, device))
            gemm_out = dict(multiplier=tr.multiplier, bias=tr.bias,
                            clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                            out_kind=out_kind)
        xf = torch.from_numpy(rng.normal(0, 1, (batch, c_in)).astype(
            np.float32)).to(device, dtype)
        xp = quantize(xf)
        wpT = bitpack(torch.from_numpy(rng.choice(
            [-1.0, 1.0], size=(units, c_in)).astype(np.float32)).to(device))
        k_pm1 = bitunpack(wpT, c_in, dtype=torch.int8).t()  # (C, U)

        def stored(y):
            return y.to(dtype) if out_kind == "float" else y

        runners = {
            ("packed", "bgemm"): lambda xp, w: bgemm(xp, wpT.t(), **gemm_out),
            ("packed", "mxu"): lambda xp, w: bdense_mxu(
                xp, w if out_kind == "float" else
                bitunpack(wpT, c_in, dtype=torch.int8).t(), tr, out_kind),
            ("float", "mxu"): lambda xf, w: stored(
                bdense_mxu_float_in(xf, w, tr, out_kind)),
            ("float", "bgemm"): lambda xf, w: stored(
                bgemm(quantize(xf), wpT.t(), **gemm_out)),
        }
        chosen = {key: run for key, run in runners.items()
                  if candidates is None or "/".join(key) in candidates}
        args = {"packed": (xp, k_pm1), "float": (xf, k_pm1)}
        for domain in ("packed", "float"):
            outs = {key: run(*args[domain]) for key, run in chosen.items()
                    if key[0] == domain}
            if outs:
                anchor = (domain, "bgemm")
                if anchor not in outs:
                    outs[anchor] = runners[anchor](*args[domain])
                _gate(outs, anchor, f"dense {(c_in, units)} {domain} "
                      f"{out_kind}")
        per = {key: _measure(run, args[key[0]], iters)
               for key, run in chosen.items()}
        results[(c_in, units)] = per
        if update_table:
            _record(per, lambda dom: (
                _key(dom, c_in, units, 1, batch, out_kind),
                _bucket_key(dom, c_in, units, 1, batch, out_kind)),
                _geometry(padding="VALID"), record_bucket)
    return results
