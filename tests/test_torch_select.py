"""Kernel selection in the port (``kernels/select.py``, the planner in
``kernels/autotune.py``) and ``kernel=`` end to end, against the JAX package
where it has the same function. The port runs its plain versions on the
CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.kernels import select as jselect
from compute_engine_tpu.models import (convert_model as jconvert,
                                       init_model as jinit,
                                       packed_apply as japply,
                                       tiny_quicknet as jtiny_quicknet)
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec
from compute_engine_tpu.runtime import Interpreter as JInterpreter

from compute_engine_tpu_torch.kernels import autotune, select
from compute_engine_tpu_torch.kernels.select import (kernel_table,
                                                     load_table,
                                                     measured_entry_tier,
                                                     reset_table, save_table,
                                                     select_bconv2d_kernel)
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             packed_apply, tiny_quicknet)
from compute_engine_tpu_torch.models.shapes import binary_layer_modes
from compute_engine_tpu_torch.models.zoo import MODELS, ModelSpec
from compute_engine_tpu_torch.runtime import Interpreter

from _torch_parity import FLOAT32_MODEL_TOL, assert_outputs_close

TABLE = os.path.join(os.path.dirname(select.__file__),
                     "kernel_table_h100.json")


@pytest.fixture(autouse=True)
def _clean_table():
    reset_table()
    yield
    reset_table()


# -- the key scheme ----------------------------------------------------------

GRID = [(c_in, c_out, fh, fw, m)
        for c_in in (1, 3, 32, 33, 64, 96, 300, 1088, 9216)
        for c_out in (1, 16, 64, 1000, 4096)
        for fh, fw in ((1, 1), (3, 3), (5, 5), (1, 9), (9, 1), (2, 3))
        for m in (0, 1, 2, 7, 128, 8 * 13 * 13, 128 * 56 * 56)]


@pytest.mark.parametrize("domain,out_kind", [("float", "float"),
                                             ("packed", "bitpacked")])
def test_keys_match_jax(domain, out_kind):
    for c_in, c_out, fh, fw, m in GRID:
        fc = select._f_coord(fh, fw)
        assert fc == jselect._f_coord(fh, fw)
        assert select._m_bucket(m) == jselect._m_bucket(m)
        assert select._c_bucket(c_in) == jselect._c_bucket(c_in)
        args = (domain, c_in, c_out, fc, m, out_kind)
        for ours, theirs in ((select._key, jselect._key),
                             (select._bucket_key, jselect._bucket_key)):
            key = ours(*args)
            assert key == theirs(*args)
            text = "|".join(str(p) for p in key)
            assert select._parse_key(text) == jselect._parse_key(text) == key
    # A rectangular filter never collides with a square one of equal area.
    assert select._f_coord(1, 9) == "1x9" and select._f_coord(3, 3) == 9


# -- the table ---------------------------------------------------------------


def test_table_roundtrip(tmp_path):
    key = ("packed", 128, 128, 9, 17, "float")
    bucket = ("b", "float", 6, 6, "1x9", 3, "float")
    kernel_table().clear()
    kernel_table()[key] = {"s1/one": "bgemm", "s2/zero": "mxu"}
    kernel_table()[bucket] = {"s1/one": "mxu"}
    path = str(tmp_path / "table.json")
    save_table(path, {"card": "test"})
    assert json.load(open(path))["_meta"] == {"card": "test"}
    kernel_table().clear()
    load_table(path)
    assert kernel_table() == {key: {"s1/one": "bgemm", "s2/zero": "mxu"},
                              bucket: {"s1/one": "mxu"}}
    reset_table()
    assert kernel_table() == select._DEFAULT_TABLE


def test_heuristic_without_a_table():
    """Where nothing is measured: the block kernel where it applies, one or
    zero padding; for a zero-padded float conv it does not run, "mxu" at
    stride 2 or under 2**15 rows; the binary GEMM elsewhere."""
    kernel_table().clear()
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56) == "residual"
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56, pad_value=0) == "residual"
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=8 * 56 * 56, pad_value=0) == "residual"
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56, pad_value=0,
                                 dilation=(2, 2)) == "bgemm"
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=8 * 56 * 56, pad_value=0,
                                 dilation=(2, 2)) == "mxu"
    assert select_bconv2d_kernel("float", c_in=64, c_out=128, fh=3, fw=3,
                                 m=128 * 28 * 28, stride=(2, 2),
                                 pad_value=0) == "mxu"
    assert select_bconv2d_kernel("float", c_in=64, c_out=128, fh=3, fw=3,
                                 m=128 * 28 * 28,
                                 stride=(2, 2)) == "bgemm"
    assert select_bconv2d_kernel("float", c_in=96, c_out=256, fh=5, fw=5,
                                 m=128 * 27 * 27) == "bgemm"
    assert select_bconv2d_kernel("packed", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56) == "bgemm"
    assert select_bconv2d_kernel("float", c_in=9216, c_out=4096, fh=1,
                                 fw=1, m=128) == "bgemm"


def test_measured_table_overrides_heuristic():
    key = ("float", 64, 64, 9, select._m_bucket(128 * 56 * 56), "float")
    kernel_table()[key] = {"s1/one": "s2d", "s1/one/g2": "s2d"}
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56) == "s2d"
    # ...but constraint-violating shapes still fall back.
    assert select_bconv2d_kernel("float", c_in=64, c_out=64, fh=3, fw=3,
                                 m=128 * 56 * 56, groups=2) == "mxu"


def test_entry_decides_only_its_own_geometry():
    """A winner measured at one stride or padding never decides a layer of
    another under the same key: BinaryResNet-E18's one-padded stride-2
    downsample shares its key with Bi-RealNet's zero-padded one, and a
    stride-1 zero-padded conv shares QuickNet's."""
    down = dict(c_in=64, c_out=128, fh=3, fw=3, m=128 * 28 * 28,
                stride=(2, 2))
    key = select._key("float", 64, 128, 9, 128 * 28 * 28, "float")
    kernel_table().clear()
    kernel_table()[key] = {"s2/zero": "mxu"}
    assert select_bconv2d_kernel("float", pad_value=0, **down) == "mxu"
    assert measured_entry_tier("float", pad_value=0, **down) == "exact"
    assert measured_entry_tier("float", **down) == ""
    assert select_bconv2d_kernel("float", **down) == "bgemm"
    kernel_table()[key] = {"s2/one": "s2d"}
    assert select_bconv2d_kernel("float", **down) == "s2d"
    assert select_bconv2d_kernel("float", pad_value=0, **down) == "mxu"
    # The bucket tier is held to the geometry too.
    same = dict(c_in=64, c_out=64, fh=3, fw=3, m=128 * 56 * 56)
    kernel_table()[select._bucket_key("float", 64, 64, 9, 128 * 56 * 56,
                                      "float")] = {"s1/one": "mxu"}
    assert select_bconv2d_kernel("float", **same) == "mxu"
    assert measured_entry_tier("float", **same) == "bucket"
    assert measured_entry_tier("float", pad_value=0, **same) == ""
    assert select_bconv2d_kernel("float", pad_value=0, **same) == "residual"


def _stub_times(monkeypatch, times):
    it = iter(times)
    monkeypatch.setattr("compute_engine_tpu_torch.runtime.microbench.time_fn",
                        lambda fn, args, iters=100, repeats=3, **kw: next(it))


def test_autotune_records_winners(monkeypatch):
    """Each candidate is measured (after the exactness gate) and the winner
    of each domain recorded; candidates in order packed/bgemm, packed/mxu,
    float/residual, float/mxu, float/bgemm, float/s2d."""
    _stub_times(monkeypatch, [3.0, 1.0, 5.0, 6.0, 7.0, 8.0])
    res = select.autotune_bconv2d([(8, 8, 64, 32, 3)], batch=2, iters=1,
                                  device="cpu")
    per = res[(8, 8, 64, 32, 3)]
    assert list(per) == [("packed", "bgemm"), ("packed", "mxu"),
                         ("float", "residual"), ("float", "mxu"),
                         ("float", "bgemm"), ("float", "s2d")]
    m = select._m_bucket(2 * 8 * 8)
    assert kernel_table()[("packed", 64, 32, 9, m, "float")] == {
        "s1/one": "mxu"}
    assert kernel_table()[("float", 64, 32, 9, m, "float")] == {
        "s1/one": "residual"}
    # record_bucket also writes the bucket key; a candidate subset is
    # honoured.
    _stub_times(monkeypatch, [2.0, 1.0])
    res = select.autotune_bconv2d(
        [{"h": 9, "w": 9, "c_in": 48, "c_out": 48, "fh": 3, "stride": 2,
          "pad_value": 0}], batch=1, out_kind="bitpacked", iters=1,
        record_bucket=True, candidates={"float/mxu", "float/bgemm"},
        device="cpu")
    (per,) = res.values()
    assert list(per) == [("float", "mxu"), ("float", "bgemm")]
    assert kernel_table()[select._bucket_key(
        "float", 48, 48, 9, 25, "bitpacked")] == {"s2/zero": "bgemm"}


def test_autotune_bdense_records_winners(monkeypatch):
    _stub_times(monkeypatch, [2.0, 1.0, 4.0, 3.0])
    res = select.autotune_bdense([(64, 32)], batch=2, iters=1, device="cpu")
    assert list(res[(64, 32)]) == [("packed", "bgemm"), ("packed", "mxu"),
                                   ("float", "mxu"), ("float", "bgemm")]
    assert kernel_table()[("packed", 64, 32, 1, 1, "float")] == {
        "s1/valid": "mxu"}
    assert kernel_table()[("float", 64, 32, 1, 1, "float")] == {
        "s1/valid": "bgemm"}
    _stub_times(monkeypatch, [2.0, 1.0])
    select.autotune_bdense([(100, 40)], batch=3, iters=1, device="cpu",
                           out_kind="bitpacked",
                           candidates={"packed/bgemm", "packed/mxu"})
    assert kernel_table()[("packed", 100, 40, 1, 1, "bitpacked")] == {
        "s1/valid": "mxu"}
    assert select_bconv2d_kernel("packed", c_in=100, c_out=40, fh=1, fw=1,
                                 m=3, out_kind="bitpacked",
                                 padding="VALID") == "mxu"


def test_autotune_refuses_a_candidate_that_differs(monkeypatch):
    """The exactness gate: a lowering whose output is not the GEMM's is
    never timed or recorded."""
    from compute_engine_tpu_torch.kernels import bconv2d as kb

    real = kb.bconv2d_mxu_float_in
    monkeypatch.setattr(kb, "bconv2d_mxu_float_in",
                        lambda *a, **kw: real(*a, **kw) + 1.0)
    _stub_times(monkeypatch, [1.0] * 8)
    before = dict(kernel_table())
    with pytest.raises(RuntimeError, match="float/mxu differs"):
        select.autotune_bconv2d([(6, 6, 32, 32, 3)], batch=1, iters=1,
                                device="cpu")
    assert kernel_table() == before


# -- the committed H100 table -----------------------------------------------


def test_committed_table_names_an_nvidia_card():
    meta = json.load(open(TABLE))["_meta"]
    assert meta["card"].startswith("NVIDIA"), meta["card"]
    assert "W" in meta["card"].split(",")[-1]
    assert meta["batches"] and meta["torch"] and meta["cuda"]
    assert select._DEFAULT_TABLE, "kernel_table_h100.json missing or empty"
    names = {w for by_geo in select._DEFAULT_TABLE.values()
             for w in by_geo.values()}
    assert names <= {"residual", "bgemm", "mxu", "s2d"}, names


# sha256 of the committed table's entries other than those at "s1/zero",
# and of its ``_meta`` without those cells' ``raw_ms`` rows and without
# ``remeasured``, as ``_kept_digest`` reads them: the table before its
# "s1/zero" entries were measured again with the zero-padded block kernel
# among the candidates.
KEPT_DIGEST = ("1dd662afb6d1235b65f34d0034188b23"
               "d083311d1ee7a2d98f5b0a66410ea55f")


def _zero_s1_row(label):
    return '"stride":[1,1]' in label and '"pad_value":0' in label


def _kept_digest(data):
    import hashlib

    entries = {k: {g: w for g, w in v.items() if g != "s1/zero"}
               for k, v in data.items() if not k.startswith("_")}
    meta = {k: v for k, v in data["_meta"].items()
            if k not in ("raw_ms", "remeasured")}
    meta["raw_ms"] = {k: v for k, v in data["_meta"]["raw_ms"].items()
                      if not _zero_s1_row(k)}
    return hashlib.sha256(json.dumps([entries, meta],
                                     sort_keys=True).encode()).hexdigest()


def test_committed_table_keeps_every_other_entry():
    """Only the zero-padded stride-1 entries were measured again: every
    other entry, every other field of ``_meta`` and every other time are
    what they were, and each re-measured cell's row names the block kernel
    and the card that measured it."""
    data = json.load(open(TABLE))
    assert _kept_digest(data) == KEPT_DIGEST
    rows = {k: v for k, v in data["_meta"]["raw_ms"].items()
            if _zero_s1_row(k)}
    assert len(rows) == 12
    assert all("float/residual" in v for v in rows.values())
    remeasured = data["_meta"]["remeasured"]["s1/zero"]
    assert remeasured["card"].startswith("NVIDIA")


def test_committed_table_runs_birealnets_stride1_convs_on_the_block():
    """Bi-RealNet-18's 13 zero-padded 3x3 stride-1 convs take the block
    kernel at batch 128; its three stride-2 convs keep "mxu"."""
    got = {}
    for _, r, domain, out_kind in binary_layer_modes(MODELS["birealnet18"],
                                                     128):
        kw = select.layer_kwargs(r)
        got.setdefault((tuple(kw["stride"]), kw["pad_value"]), []).append(
            select.layer_lowering("auto", r, domain, out_kind))
    assert got == {((1, 1), 0): ["residual"] * 13, ((2, 2), 0): ["mxu"] * 3}


def test_planner_measures_one_geometry_again(monkeypatch, tmp_path):
    """``autotune --geometry s1/zero`` measures the cells of that geometry
    only and writes every other entry and every other time back as it
    was."""
    cells = []

    def measure(cell, device="cuda", update_table=True):
        cells.append(cell)
        kind, r, _, domain, out_kind = cell
        key, bucket, geo = autotune._keys(kind, r, domain, out_kind)
        for k in (key, bucket):
            kernel_table().setdefault(k, {})[geo] = "s2d"
        return {"float/residual": 2.0, "float/s2d": 1.0}

    monkeypatch.setattr(autotune, "measure", measure)
    out = tmp_path / "table.json"
    autotune.main(["--geometry", "s1/zero", "--out", str(out)])
    assert cells and all(autotune._cell_geometry(c) == "s1/zero"
                         for c in cells)
    data, old = json.load(open(out)), json.load(open(TABLE))
    assert _kept_digest(data) == _kept_digest(old)
    for k, v in old.items():
        if not k.startswith("_") and "s1/zero" in v:
            assert data[k]["s1/zero"] == "s2d"
    labels = {autotune.cell_label(c) for c in cells}
    assert labels == {k for k in old["_meta"]["raw_ms"] if _zero_s1_row(k)}
    assert all(data["_meta"]["raw_ms"][k] == {"float/residual": 2.0,
                                              "float/s2d": 1.0}
               for k in labels)
    assert set(data["_meta"]["remeasured"]["s1/zero"]) == {
        "card", "torch", "cuda", "timer", "written_by"}


def test_committed_table_covers_zoo_shapes():
    """Every binary conv and binary dense of the nine zoo models, at batch
    1, 8 and 128, in every (domain, out_kind) the runtime consults the table
    in (``binary_layer_modes``), dispatches from an exact or a bucket entry
    measured at its own stride and padding."""
    missing = []
    n_layers = 0
    for name, spec in MODELS.items():
        for batch in (1, 8, 128):
            modes = binary_layer_modes(spec, batch)
            assert modes, name
            for _, r, domain, out_kind in modes:
                n_layers += 1
                if not measured_entry_tier(domain, out_kind=out_kind,
                                           **select.layer_kwargs(r)):
                    missing.append((name, batch, domain, out_kind,
                                    r["name"]))
    assert n_layers > 500, "shape walk looks broken (too few layers)"
    assert not missing, (f"{len(missing)} zoo layer dispatches fall to the "
                         f"heuristic: {missing[:10]}")
    # A rerun of the planner over the committed table measures nothing.
    assert autotune.plan() == []


def test_modes_follow_the_packed_domain_chain():
    """The packed domain is consulted where a binary layer reads another's
    output, and each layer in it writes what its readers take: BinaryAlexNet
    chains every binary layer into the next and feeds fc2 to its float head;
    QuickNet's binary convs feed residual adds only."""
    alex = binary_layer_modes(MODELS["binary_alexnet"], 2)
    packed = [(r["name"], out_kind) for _, r, d, out_kind in alex
              if d == "packed"]
    assert packed == [("conv2", "bitpacked"), ("conv3", "bitpacked"),
                      ("conv4", "bitpacked"), ("conv5", "bitpacked"),
                      ("fc1", "bitpacked"), ("fc2", "float")]
    assert {d for _, _, d, _ in binary_layer_modes(MODELS["quicknet"], 2)} \
        == {"float"}
    spec = ModelSpec("m", _mini_alexnet, input_size=(40, 40), num_classes=10)
    assert [o for _, _, d, o in binary_layer_modes(spec, 1)
            if d == "packed"] == ["bitpacked"] * 5 + ["float"]

    def both(b, x):
        """A binary layer read by a binary layer and by a residual add."""
        x = b.conv_bn(x, 32, 3, name="stem")
        y = b.binary_conv_bn(x, 32, 3, name="a")
        z = b.binary_conv_bn(y, 32, 3, name="b")
        return b.softmax(b.dense(b.global_avg_pool(b.add(y, z)), 4,
                                 name="head"))

    modes = binary_layer_modes(ModelSpec("both", both, (8, 8), 4), 1)
    assert [(r["name"], o) for _, r, d, o in modes if d == "packed"] == [
        ("a", "bitpacked"), ("a", "float"), ("b", "float")]


def test_planner_measures_one_cell_per_bucket():
    kernel_table().clear()
    cells = autotune.plan(["quicknet", "binary_alexnet"], (128, 1))
    keys = set()
    for kind, r, batch, domain, out_kind in cells:
        assert r["m"] == batch * (r["out_h"] * r["out_w"] if kind == "conv"
                                  else 1)
        bk = select._bucket_key(domain, r["c_in"], r.get("c_out", r.get(
            "units")), select._f_coord(r.get("fh", 1), r.get("fw", 1)),
            r["m"], out_kind)
        assert bk not in keys
        keys.add(bk)
    assert {c[3:] for c in cells} == {("float", "float"),
                                      ("packed", "bitpacked"),
                                      ("packed", "float")}
    # With an empty table passed in and without buckets, one cell per shape.
    assert len(autotune.plan(["binary_alexnet"], (128,), table={},
                             buckets=False)) == 12


def test_planner_measures_each_geometry():
    """Two layers under one key at different strides or paddings are two
    cells: Bi-RealNet's zero-padded and BinaryResNet-E18's one-padded
    stride-2 downsample convs."""
    kernel_table().clear()
    cells = autotune.plan(["birealnet18", "binary_resnet_e18"], (128,))
    geos = {(r["c_in"], r["c_out"], tuple(r["stride"]), r["pad_value"])
            for kind, r, *_ in cells if kind == "conv"}
    for c_in in (64, 128, 256):
        assert (c_in, 2 * c_in, (2, 2), 0) in geos
        assert (c_in, 2 * c_in, (2, 2), 1) in geos
    assert (64, 64, (1, 1), 0) in geos and (64, 64, (1, 1), 1) in geos


def test_planner_keys_rectangular_filters_apart():
    """A 1x9 and a 3x3 conv of the same channels and rows are two cells."""
    def fwd(b, x):
        x = b.conv_bn(x, 32, 3, name="stem")
        x = b.binary_conv_bn(x, 32, (1, 9), name="wide")
        x = b.binary_conv_bn(x, 32, 3, name="square")
        x = b.global_avg_pool(x)
        return b.softmax(b.dense(x, 4, name="head"))

    kernel_table().clear()
    spec = ModelSpec("rect", fwd, input_size=(8, 8), num_classes=4)
    cells = autotune.plan([spec], (2,))
    assert [(c[1]["fh"], c[1]["fw"], c[3]) for c in cells] == [
        (1, 9, "float"), (3, 3, "float"), (1, 9, "packed"),
        (3, 3, "packed")]


# -- kernel= end to end ------------------------------------------------------

JSPEC = jtiny_quicknet(num_classes=16)
SPEC = tiny_quicknet(num_classes=16)


@pytest.fixture(scope="module")
def quicknet_layers():
    params = jinit(JSPEC, seed=5, randomize_bn=True)
    return jconvert(JSPEC, params)


@pytest.mark.parametrize("kernel", ["auto", "residual", "bgemm", "mxu",
                                    "s2d", "reference"])
def test_interpreter_kernel_matches_jax(quicknet_layers, kernel):
    x = np.random.default_rng(11).normal(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    want = JInterpreter(JSPEC, quicknet_layers, kernel=kernel,
                        compute_dtype=jnp.float32).predict(x)
    interp = Interpreter(SPEC, quicknet_layers, kernel=kernel,
                         compute_dtype=torch.float32, device="cpu")
    assert interp.kernel == kernel
    assert_outputs_close(interp.predict(x), want, **FLOAT32_MODEL_TOL)


def test_interpreter_refuses_unknown_kernel(quicknet_layers):
    with pytest.raises(ValueError, match="unknown kernel"):
        Interpreter(SPEC, quicknet_layers, kernel="winograd", device="cpu")


def _mini_alexnet(b, x, num_classes=10):
    """BinaryAlexNet's topology at toy scale (tests/test_packed_domain.py)."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv4")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 2, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 128, name="fc1")
    x = b.binary_dense_bn(x, 128, name="fc2")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


@pytest.mark.parametrize("domain", ["packed", "float"])
@pytest.mark.parametrize("kernel", ["auto", "bgemm", "mxu", "residual",
                                    "s2d", "reference"])
def test_packed_apply_kernel_matches_jax(domain, kernel):
    """A toy BinaryAlexNet in both domains, each kernel= value."""
    jspec = JModelSpec("m", _mini_alexnet, input_size=(40, 40),
                       num_classes=10)
    spec = ModelSpec("m", _mini_alexnet, input_size=(40, 40),
                     num_classes=10)
    layers = jconvert(jspec, jinit(jspec, seed=2, randomize_bn=True))
    x = np.random.default_rng(3).normal(0, 1, (3, 40, 40, 3)).astype(
        np.float32)
    want = japply(jspec, layers, jnp.asarray(x), kernel=kernel,
                  compute_dtype=jnp.float32, domain=domain)
    got = packed_apply(spec, layers, x, kernel=kernel,
                       compute_dtype=torch.float32, domain=domain,
                       device="cpu")
    assert_outputs_close(got, want, **FLOAT32_MODEL_TOL)


def test_int8_pipeline_keeps_the_gemm_for_int8_outputs(monkeypatch):
    """An int8-output binary conv takes the GEMM's int8 epilogue whatever
    kernel= says: the same logits for every value."""
    from compute_engine_tpu_torch.models import calibrate_model

    spec = tiny_quicknet(num_classes=8)
    params = init_model(spec, seed=4, randomize_bn=True)
    x = np.random.default_rng(4).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    in_r, out_r = calibrate_model(spec, params, [x], with_outputs=True,
                                  device="cpu")
    layers = convert_model(spec, params, int8_ranges=in_r,
                           int8_out_ranges=out_r)
    outs = [packed_apply(spec, layers, x, kernel=k, return_logits=True,
                         device="cpu")
            for k in ("auto", "bgemm", "mxu", "s2d", "residual")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_planner_measures_and_records_a_cell(monkeypatch):
    """``autotune.measure`` runs one planned cell's domain (gate, timing)
    and records its winner under the exact and the bucket key, at the
    cell's geometry; with ``update_table=False`` it records nothing."""
    kernel_table().clear()
    cell = ("conv", {"h": 6, "w": 6, "c_in": 32, "c_out": 32, "fh": 3,
                     "fw": 3, "stride": (1, 1), "padding": "SAME",
                     "pad_value": 1, "m": 2 * 6 * 6}, 2, "float", "float")
    _stub_times(monkeypatch, [4.0, 3.0, 2.0, 1.0])
    per = autotune.measure(cell, device="cpu", update_table=False)
    assert kernel_table() == {}
    _stub_times(monkeypatch, [4.0, 3.0, 2.0, 1.0])
    assert autotune.measure(cell, device="cpu") == per
    assert per == {"float/residual": 4e3, "float/mxu": 3e3,
                   "float/bgemm": 2e3, "float/s2d": 1e3}
    args = ("float", 32, 32, 9, 2 * 6 * 6, "float")
    assert kernel_table()[select._key(*args)] == {"s1/one": "s2d"}
    assert kernel_table()[select._bucket_key(*args)] == {"s1/one": "s2d"}


# -- one dispatch: the runtime's lowering and the launches it predicts -------


def _launches_of(run):
    """(block, GEMM, split-K) calls a CPU forward makes, counted by stubs
    around the plain versions."""
    from compute_engine_tpu_torch.kernels.bgemm import (bgemm_plain,
                                                        uses_split_k)
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block_plain)

    counts = [0, 0, 0]

    def block(*a, **kw):
        counts[0] += 1
        return binary_residual_block_plain(*a, **kw)

    def gemm(lhs, rhs, *a, **kw):
        counts[2 if uses_split_k(lhs.shape[1]) else 1] += 1
        return bgemm_plain(lhs, rhs, *a, **kw)

    run(block, gemm)
    return tuple(counts)


@pytest.mark.parametrize("domain", ["float", "packed"])
@pytest.mark.parametrize("kernel", ["auto", "residual", "bgemm", "mxu",
                                    "s2d", "reference"])
def test_layer_lowering_predicts_the_forward(domain, kernel):
    """``layer_lowering``/``layer_launches`` over ``binary_layer_modes``
    give the kernel launches that the forward itself makes, for each
    kernel= value, on a toy BinaryAlexNet with a table that sends the
    float domain's layers to three different lowerings."""
    from compute_engine_tpu_torch.models import prepare_runtime_arrays

    spec = ModelSpec("m", _mini_alexnet, input_size=(40, 40),
                     num_classes=10)
    layers = prepare_runtime_arrays(convert_model(
        spec, init_model(spec, seed=2, randomize_bn=True)))
    x = np.random.default_rng(3).normal(0, 1, (2, 40, 40, 3)).astype(
        np.float32)
    kernel_table().clear()
    m = select._m_bucket(2 * 4 * 4)  # conv3..conv5 run at 4x4
    kernel_table()[("float", 64, 96, 9, m, "float")] = {"s1/one": "mxu"}
    kernel_table()[("float", 96, 96, 9, m, "float")] = {"s1/one": "bgemm"}
    want = [0, 0, 0]
    for _, r, d, out_kind in binary_layer_modes(spec, 2):
        if d == domain:
            low = select.layer_lowering(kernel, r, d, out_kind)
            want = [a + b for a, b in zip(want, select.layer_launches(low,
                                                                      r))]
    got = _launches_of(lambda block, gemm: packed_apply(
        spec, layers, x, kernel=kernel, domain=domain, device="cpu",
        residual_block=block, gemm=gemm))
    assert got == tuple(want)
    if kernel == "auto" and domain == "float":
        # conv2 and conv5 on the block, conv3 on "mxu", conv4 and the two
        # denses on the GEMM.
        assert got == (2, 3, 0)


def test_layer_launches_split_k_and_groups():
    conv = dict(c_in=9216, c_out=64, fh=3, fw=3, m=8)
    assert select.layer_launches("bgemm", conv) == (0, 0, 1)
    assert select.layer_launches("bgemm", dict(conv, c_in=3584)) == (0, 1, 0)
    assert select.layer_launches("bgemm", dict(conv, c_in=128,
                                               groups=4)) == (0, 4, 0)
    assert select.layer_launches("bgemm", dict(c_in=40000, units=10,
                                               m=1)) == (0, 0, 1)
    assert select.layer_launches("residual", conv) == (1, 0, 0)
    assert select.layer_launches("mxu", conv) == (0, 0, 0)
