"""The planner: measure the selection table on the card and write it.

Walks ``binary_layer_modes`` of the zoo models at each batch: every table
consultation the model runtime makes, in the domain and output kind it makes
it in. Each layer gives an exact key (keyed with ``_f_coord``) and a bucket
key, both at the layer's geometry (stride, padding kind; ``select._geometry``);
a layer whose exact or bucket key already holds an entry at its geometry is
skipped, so the first layer of a bucket and geometry is measured as its
representative and its winner is recorded under both keys. A rerun over a
table that covers every layer measures nothing.

Every candidate passes the exactness gate of ``autotune_bconv2d`` /
``autotune_bdense`` before it is timed. Usage, on the card:

  python -m compute_engine_tpu_torch.kernels.autotune --fresh [--out FILE]

writes the table (by default the package's ``kernel_table_h100.json``) with
its ``_meta`` (the card's name and power limit, the software, the batches
and every measured time), checkpointing after every cell. Without
``--fresh`` it starts from the committed table and measures only what that
misses. ``--geometry G`` (e.g. ``s1/zero``, after a new candidate appeared
at it) takes the committed table's entries at G out, exact and bucket, and
measures them again: every other entry, and every other field and time of
``_meta``, is written back as it was; the new times replace their rows of
``raw_ms`` and ``_meta["remeasured"][G]`` names the card and the software
that measured them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from . import select

__all__ = ["plan", "measure", "cell_label", "main"]

# Main-path models first: their layers are measured at their own keys.
MODEL_ORDER = ("quicknet", "binary_alexnet", "quicknet_small",
               "quicknet_large", "birealnet18", "binary_resnet_e18",
               "binary_densenet28", "binary_densenet37", "binary_densenet45")
BATCHES = (128, 1, 8)
_SHAPE_KEYS = ("h", "w", "c_in", "c_out", "fh", "fw", "stride", "padding",
               "pad_value")


def _keys(kind, r, domain, out_kind):
    """(exact key, bucket key, geometry) of one table consultation."""
    kw = select.layer_kwargs(r)
    args = (domain, kw["c_in"], kw["c_out"], select._f_coord(kw["fh"],
                                                             kw["fw"]),
            kw["m"], out_kind)
    geo = select._geometry(kw["stride"], kw["padding"], kw["pad_value"],
                           kw["dilation"], kw["groups"])
    return select._key(*args), select._bucket_key(*args), geo


def plan(models=MODEL_ORDER, batches=BATCHES, table=None, buckets=True):
    """Cells to measure, in order: (kind, record, batch, domain, out_kind)
    with kind "conv" or "dense" and the record of ``binary_layer_shapes``.

    ``models`` are zoo names or ModelSpecs. A consultation is skipped where
    ``table`` (the process table by default; ``{}`` plans every shape)
    already holds its exact or bucket key at its geometry, or where an
    earlier cell has it: with ``buckets`` one cell is planned per bucket,
    without it one per exact key."""
    from ..models.shapes import binary_layer_modes
    from ..models.zoo import get_model

    table = select.kernel_table() if table is None else table
    planned = set()
    cells = []
    for batch in batches:
        for model in models:
            spec = get_model(model) if isinstance(model, str) else model
            for kind, r, domain, out_kind in binary_layer_modes(spec, batch):
                key, bucket, geo = _keys(kind, r, domain, out_kind)
                if any(geo in table.get(k, {}) for k in (key, bucket)):
                    continue
                if (key, geo) in planned or (buckets
                                             and (bucket, geo) in planned):
                    continue
                planned.update({(key, geo), (bucket, geo)})
                cells.append((kind, r, batch, domain, out_kind))
    return cells


def cell_label(cell):
    kind, r, batch, domain, out_kind = cell
    shape = ({k: r[k] for k in _SHAPE_KEYS} if kind == "conv"
             else [r["c_in"], r["units"]])
    return (f"{kind} b{batch} {domain}/{out_kind} "
            f"{json.dumps(shape, separators=(',', ':'))}")


def measure(cell, device="cuda", update_table=True):
    """Measure one cell's domain; with ``update_table`` record its winner
    (exact and bucket keys, at the cell's geometry). Returns
    {candidate: ms}."""
    kind, r, batch, domain, out_kind = cell
    cands = {f"{domain}/{c}" for c in select.CANDIDATES[domain]}
    if kind == "conv":
        res = select.autotune_bconv2d(
            [{k: r[k] for k in _SHAPE_KEYS}], batch=batch, out_kind=out_kind,
            record_bucket=True, update_table=update_table, candidates=cands,
            device=device)
    else:
        res = select.autotune_bdense(
            [(r["c_in"], r["units"])], batch=batch, out_kind=out_kind,
            record_bucket=True, update_table=update_table, candidates=cands,
            device=device)
    (per,) = res.values()
    return {f"{d}/{k}": t * 1e3 for (d, k), t in per.items()}


def _meta(raw):
    import torch

    from ..runtime.microbench import card_line

    return {"card": card_line() if torch.cuda.is_available() else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "batches": list(BATCHES),
            "timer": "runtime.microbench.time_fn: CUDA-graph replay of 20 "
                     "calls, CUDA events, median of 3",
            "written_by": "python -m compute_engine_tpu_torch.kernels."
                          "autotune",
            "raw_ms": raw}


def _cell_geometry(cell):
    return _keys(cell[0], cell[1], cell[3], cell[4])[2]


def forget_geometry(geo, table=None) -> int:
    """Take every entry at geometry ``geo`` out of ``table`` (the process
    table by default), so that ``plan`` measures it again; returns how many
    were taken out."""
    table = select.kernel_table() if table is None else table
    gone = 0
    for key in list(table):
        if table[key].pop(geo, None) is not None:
            gone += 1
        if not table[key]:
            del table[key]
    return gone


def remeasured_meta(old, raw, geo, now):
    """The committed ``_meta`` with the times of ``raw`` in its ``raw_ms``
    (a row of the same cell replaced) and ``now`` (``_meta``'s card and
    software fields, from this run) under ``remeasured[geo]``."""
    meta = json.loads(json.dumps(old))
    meta["raw_ms"].update(raw)
    meta.setdefault("remeasured", {})[geo] = {
        k: now[k] for k in ("card", "torch", "cuda", "timer", "written_by")}
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=select._TABLE_PATH)
    p.add_argument("--fresh", action="store_true",
                   help="start from an empty table, not the committed one")
    p.add_argument("--geometry",
                   help="measure the committed entries at this geometry "
                        "again (e.g. s1/zero), keeping every other one")
    args = p.parse_args(argv)
    select.reset_table()
    if args.fresh:
        select.kernel_table().clear()
    if args.geometry:
        with open(select._TABLE_PATH) as f:
            committed = json.load(f)["_meta"]
        print(f"took {forget_geometry(args.geometry)} entries at "
              f"{args.geometry} out", flush=True)
    cells = plan()
    if args.geometry:
        cells = [c for c in cells if _cell_geometry(c) == args.geometry]

    def meta(raw):
        if args.geometry:
            return remeasured_meta(committed, raw, args.geometry, _meta({}))
        return _meta(raw)

    print(f"{len(cells)} cells to measure", flush=True)
    raw = {}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for i, cell in enumerate(cells):
        t0 = time.perf_counter()
        per = measure(cell)
        label = cell_label(cell)
        raw[label] = per
        best = min(per, key=per.get)
        print(f"[{i + 1}/{len(cells)}] {label}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in per.items())
              + f" -> {best} ({time.perf_counter() - t0:.1f} s)", flush=True)
        select.save_table(args.out, meta(raw))
    if not cells:
        select.save_table(args.out, meta(raw))
    print(f"wrote {args.out} ({len(select.kernel_table())} entries)")


if __name__ == "__main__":
    main()
