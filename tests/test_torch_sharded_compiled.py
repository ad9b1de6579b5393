"""The compiled sharded forward (``runtime.compiled.CompiledParts`` behind
``ShardedInterpreter``, ``MultiHostServer`` and the scaling report) on
``cpu`` slots, with the card's graph, stream and event objects replaced by
the stand-ins of ``_torch_card_standins.py``.

On ``cpu`` slots ``ShardedInterpreter`` compiles nothing; here
``plan_case`` is patched to read each ``cpu`` slot as a card, so that the
interpreter compiles as it would on the card: case A (every slot card 0,
one graph), B (data group d on card d, one graph per group) or C (segments
between the copies of ``_split_at_slots``). The stand-in graphs record the
operations of each segment and replay them on the same tensors; the copies
between segments run as the plan's own steps.

Stated tolerances: compiled against eager ``sharded_apply`` outputs
``torch.equal``; against JAX's ``ShardedInterpreter`` within
``parity.FLOAT32_MODEL_TOL`` with equal top-1 (the float layers of the two
packages round in different places).
"""

import importlib.util
import pathlib
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.models import convert_model as jconvert
from compute_engine_tpu.models import init_model as jinit
from compute_engine_tpu.models import tiny_quicknet as jtiny_quicknet
from compute_engine_tpu.runtime.distributed_serving import (
    ShardedInterpreter as JShardedInterpreter)

from compute_engine_tpu_torch.kernels import counts, debug_checks
from compute_engine_tpu_torch.kernels.bgemm import bgemm
from compute_engine_tpu_torch.kernels.residual import binary_residual_block
from compute_engine_tpu_torch.models import (convert_model, init_model,
                                             prepare_runtime_arrays,
                                             tiny_quicknet)
from compute_engine_tpu_torch.models.zoo import ModelSpec
from compute_engine_tpu_torch.parallel import (collective, make_mesh,
                                               shard_artifact)
from compute_engine_tpu_torch.parallel.partition import (group_apply,
                                                         partition_layers,
                                                         sharded_apply)
from compute_engine_tpu_torch.runtime import compiled
from compute_engine_tpu_torch.runtime import distributed_serving as ds
from compute_engine_tpu_torch.runtime.compiled import CompiledParts
from compute_engine_tpu_torch.scripts import tp_scaling_report as tsr

import _torch_card_standins as standins
import _torch_parity as parity
from _torch_card_standins import FakeGraph

REPO = pathlib.Path(__file__).parents[1]
CPU = torch.device("cpu")
WAIT = 30
TINY = dict(section_filters=(32,), section_blocks=(1,), num_classes=5,
            input_size=16)
F32 = torch.float32
PLAN_CASE = ds.plan_case


def _as_cards(case):
    """A ``plan_case`` that reads ``cpu`` slots as cards: every slot card 0
    ("A"), data group d on card d ("B"), slot ``cpu:i`` as card i
    ("cards"), or as it is otherwise (with ``_split_at_slots``, "C")."""
    real = PLAN_CASE

    def plan_case(groups, split_at_slots=False):
        if case == "cards":
            return real([[torch.device("cuda", d.index or 0) for d in g]
                         for g in groups], split_at_slots)
        if case == "B":
            return real([[torch.device("cuda", d)] * len(g)
                         for d, g in enumerate(groups)], split_at_slots)
        return real([[torch.device("cuda", 0)] * len(g) for g in groups],
                    split_at_slots)

    return plan_case


@pytest.fixture
def card(monkeypatch):
    """The stand-ins, and ``plan_case`` reading ``cpu`` slots as cards by
    the case named: ``card("A")`` etc."""
    record = standins.install(monkeypatch)

    def use(case):
        monkeypatch.setattr(ds, "plan_case", _as_cards(case))
        return record

    return use


@pytest.fixture(scope="module")
def tiny():
    spec = tiny_quicknet(**TINY)
    layers = convert_model(spec, init_model(spec, seed=7, randomize_bn=True))
    return spec, layers


def _interp(spec, layers, case, dp=4, tp=2, **kw):
    return ds.ShardedInterpreter(spec, layers, dp=dp, tp=tp,
                                 compute_dtype=F32, devices=["cpu"] * (dp * tp),
                                 _split_at_slots=case == "C", **kw)


def _eager(interp, x):
    return sharded_apply(interp.spec, interp.layers, torch.as_tensor(x),
                         interp.mesh, groups=interp._groups,
                         **interp._kw)


# -- the case ------------------------------------------------------------------


def _cards(*groups):
    return [[torch.device("cuda", i) for i in g] for g in groups]


@pytest.mark.parametrize("groups, split, case", [
    (_cards([0, 0], [0, 0]), False, "A"),
    (_cards([0], [0], [0], [0]), False, "A"),
    (_cards([0], [1], [2], [3]), False, "B"),
    (_cards([0, 0], [1, 1]), False, "B"),
    (_cards([0, 0], [0, 0], [1, 1], [1, 1]), False, "B"),
    (_cards([0, 1, 2, 3]), False, "C"),
    (_cards([0, 1], [2, 3]), False, "C"),
    (_cards([0, 1], [0, 1]), False, "C"),
    (_cards([0, 0]), True, "C"),
    ([[torch.device("cuda"), torch.device("cuda", 0)]], False, "A"),
    ([[torch.device("cpu")] * 2] * 4, False, None),
    ([[torch.device("cpu")] * 2], True, None),
    ([[torch.device("cuda", 0), torch.device("cpu")]], False, None),
])
def test_plan_case(groups, split, case):
    """A pure function of the slots' devices: no card is needed."""
    assert ds.plan_case(groups, split) == case


def test_cpu_slots_compile_nothing(tiny):
    spec, layers = tiny
    interp = _interp(spec, layers, None)
    x = parity.images(1, 8, size=(16, 16))
    assert torch.equal(interp(x), _eager(interp, x))
    assert interp.plan == {"case": None, "graphs": {}, "host_steps": {}}
    assert interp.compile_s == {} and interp.input_buffer(x.shape, F32) is None


# -- ShardedInterpreter --------------------------------------------------------


@pytest.mark.parametrize("case", ["A", "B", "C"])
def test_compiled_sharded_interpreter_equals_eager_and_jax(card, tiny, case):
    """dp 4, tp 2 on eight slots: every call, alternating two batches, is
    ``torch.equal`` to the eager ``sharded_apply`` and within
    ``FLOAT32_MODEL_TOL`` of JAX's ``ShardedInterpreter``; the graphs are
    captured once, at the first call."""
    record = card(case)
    spec, layers = tiny
    jspec = jtiny_quicknet(**TINY)
    jlayers = jconvert(jspec, jinit(jspec, seed=7, randomize_bn=True))
    interp = _interp(spec, layers, case)
    assert interp.case == case
    xs = [parity.images(42, 8, size=(16, 16)),
          parity.images(43, 8, size=(16, 16))]
    outs = [interp(xs[i % 2]) for i in range(4)]
    for i, got in enumerate(outs):
        assert torch.equal(got, _eager(interp, xs[i % 2])), i
    assert outs[0].data_ptr() != outs[2].data_ptr()
    assert not torch.equal(outs[0], outs[1])
    captures = len(record["captures"])
    plan = interp.plan
    key = ((8, 16, 16, 3), F32)
    assert list(plan["graphs"]) == [key] == list(interp.compile_s)
    assert captures == plan["graphs"][key]
    assert sum(g.replays for g in FakeGraph.made) == 4 * captures
    jwant = np.asarray(JShardedInterpreter(jspec, jlayers, dp=4, tp=2,
                                           compute_dtype=jnp.float32)(xs[0]))
    parity.assert_outputs_close(outs[0], jwant, **parity.FLOAT32_MODEL_TOL)


@pytest.mark.parametrize("case", ["A", "B", "C"])
def test_bf16_stream_equals_eager(card, tiny, case):
    """The bf16 stream casts its float32 input first, through an operation
    whose schema may alias (``aten.to.dtype``): it is captured with the rest,
    so each of two batches alternated equals its eager forward."""
    card(case)
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=2, tp=2,
                                   devices=["cpu"] * 4,
                                   _split_at_slots=case == "C")
    xs = [parity.images(s, 4, size=(16, 16)) for s in (11, 12)]
    for i in range(4):
        assert torch.equal(interp(xs[i % 2]), _eager(interp, xs[i % 2])), i


def test_an_aliasing_cast_is_captured(card):
    """An operation whose schema may alias its input but which computes (a
    cast) opens a segment: it replays with the rest."""
    card("A")

    def fn(x):
        return x.to(torch.bfloat16) * 2

    cp = CompiledParts([(fn, CPU, [CPU])], CPU)
    for x in (torch.arange(4.0), torch.arange(4.0) + 10, torch.arange(4.0)):
        assert torch.equal(cp(x), fn(x))
    assert cp.graphs == {((4,), F32): 1} == cp.host_steps


@pytest.mark.parametrize("case, dp, tp", [
    ("A", 4, 2), ("A", 1, 8), ("B", 4, 2), ("B", 8, 1), ("C", 1, 2),
    ("C", 2, 4)])
def test_host_steps(card, tiny, case, dp, tp):
    """One graph and one host step in case A; one graph per data group in
    case B; under ``_split_at_slots`` a copy step for every copy between
    slots that the eager forward logs, and segments between them (copies
    in a row, as a gather's, have none between them)."""
    card(case)
    spec, layers = tiny
    interp = _interp(spec, layers, case, dp=dp, tp=tp)
    x = parity.images(3, 8, size=(16, 16))
    interp(x)
    key = ((8, 16, 16, 3), F32)
    graphs, steps = interp.plan["graphs"][key], interp.plan["host_steps"][key]
    if case == "A":
        assert (graphs, steps) == (1, 1)
    elif case == "B":
        assert (graphs, steps) == (dp, dp)
    else:
        log = []
        sharded_apply(spec, interp.layers, x, interp.mesh,
                      groups=interp._groups, log=log, compute_dtype=F32)
        assert log and steps - graphs == len(log)
        assert dp < graphs <= len(log) + dp


@pytest.mark.parametrize("case", ["A", "C"])
def test_weights_read_in_place(card, tiny, case):
    """Negating one model slot's shard of a sharded filter in place (its
    packed words and its +-1 form) changes the next replay as it changes
    the eager forward."""
    card(case)
    spec, layers = tiny
    interp = _interp(spec, layers, case, dp=1, tp=2)
    x = parity.images(4, 2, size=(16, 16))
    before = interp(x)
    name = next(k for k, v in interp.layers.items()
                if v.get("kind") == "bconv")
    entry = interp.layers[name]
    for k in ("packed_filter", "filter_pm1"):
        shard = entry[k].shards[1]
        shard.copy_(~shard if k == "packed_filter" else -shard)
    after = interp(x)
    assert torch.equal(after, _eager(interp, x))
    assert not torch.equal(after, before)


def test_one_plan_per_key_and_the_static_input(card, tiny):
    """Case A: one graph per input (shape, dtype), alternated without a
    new capture; a batch written into ``input_buffer`` is not copied
    again. Several parts have no single static input."""
    record = card("A")
    spec, layers = tiny
    interp = _interp(spec, layers, "A")
    a, b = parity.images(5, 8, size=(16, 16)), parity.images(6, 16,
                                                           size=(16, 16))
    for x in (a, b, a, b):
        assert torch.equal(interp(x), _eager(interp, x))
    assert len(record["captures"]) == 2 == len(interp.compile_s)
    buf = interp.input_buffer((8, 16, 16, 3), F32)
    assert buf is interp.input_buffer([8, 16, 16, 3], F32)
    buf.copy_(torch.from_numpy(b[:8]))
    assert torch.equal(interp(buf), _eager(interp, b[:8]))
    card("B")
    assert _interp(spec, layers, "B").input_buffer((8, 16, 16, 3),
                                                   F32) is None


def test_launch_counts_per_call(card, tiny, monkeypatch):
    """A stand-in block kernel counted where the forward launches it: the
    warm-up and the captures count nothing, every call adds one forward's
    launches, in every case."""
    real = group_apply

    def counting_group_apply(*a, **kw):
        out = real(*a, **kw)
        counts.count(binary_residual_block)  # as a wrapper: after its output
        return out

    monkeypatch.setattr(binary_residual_block, "launches", 0)
    monkeypatch.setattr(bgemm, "launches", 0)
    monkeypatch.setattr("compute_engine_tpu_torch.parallel.partition."
                        "group_apply", counting_group_apply)
    monkeypatch.setattr(ds, "group_apply", counting_group_apply)
    spec, layers = tiny
    x = parity.images(6, 8, size=(16, 16))
    for case in ("A", "B", "C"):
        card(case)
        interp = _interp(spec, layers, case)
        binary_residual_block.launches = 0
        for calls in (1, 2, 3):
            interp(x)
            assert binary_residual_block.launches == 4 * calls, case
    assert bgemm.launches == 0


@pytest.mark.parametrize("compiled_as", ["forward", "parts"])
@pytest.mark.parametrize("launched_on", ["its card", "another card"])
def test_a_launch_off_the_capturing_card_raises(card, monkeypatch,
                                                compiled_as, launched_on):
    """A wrapper launches on its tensor's card, past the dispatch mode that
    finds the segments. A launch on a card whose capture is not open would
    run once, at the capture, and never at a replay: the capture raises,
    and nothing is counted. On the capturing card each call counts it."""
    card("A")
    monkeypatch.setattr(bgemm, "launches", 0)
    where = CPU if launched_on == "its card" else torch.device("cuda", 1)

    def fn(x):
        y = x * 2
        with torch.cuda.device(where):  # as a wrapper launches
            counts.count(bgemm)
        return y + 1

    run = (compiled.CompiledForward(fn, CPU) if compiled_as == "forward"
           else CompiledParts([(fn, CPU, [CPU])], CPU))
    x = torch.arange(4.0)
    if launched_on == "its card":
        for _ in range(2):
            assert torch.equal(run(x), x * 2 + 1)
        assert bgemm.launches == 2
    else:
        with pytest.raises(RuntimeError, match="not capturing"):
            run(x)
        assert bgemm.launches == 0


def test_debug_checks_refuse_a_compiled_call(card, tiny):
    card("C")
    spec, layers = tiny
    interp = _interp(spec, layers, "C")
    x = parity.images(7, 8, size=(16, 16))
    interp(x)
    with debug_checks():
        with pytest.raises(RuntimeError, match="debug_checks"):
            interp(x)
        _eager(interp, x)  # the eager forward runs the checks on the CPU


def test_a_failed_capture_raises_and_never_runs_eagerly(card, tiny,
                                                        monkeypatch):
    record = card("B")
    spec, layers = tiny
    interp = _interp(spec, layers, "B")
    x = parity.images(8, 8, size=(16, 16))
    record["fail"] = "operation not permitted when stream is capturing"
    for _ in range(2):
        with pytest.raises(RuntimeError, match="not permitted"):
            interp(x)
        assert interp.compile_s == {} and interp.plan["graphs"] == {}
    record["fail"] = None
    assert torch.equal(interp(x), _eager(interp, x))


def test_a_plan_unlike_its_warm_up_raises(card):
    """A forward whose copies between segments depend on anything but the
    input's shape is refused at its capture."""
    card("C")
    calls = []

    def fn(x):
        calls.append(1)
        y = x + 1
        if len(calls) == compiled.WARMUP + 1:  # the capture's pass
            y = compiled.split(y)
        return y * 2

    cp = CompiledParts([(fn, CPU, [CPU])], CPU)
    with pytest.raises(RuntimeError, match="not the plan of the warm-up"):
        cp(torch.zeros(4))


META = torch.device("meta")


@pytest.mark.parametrize("copy", ["to", "copy_"])
def test_segments_split_where_the_device_changes(card, copy):
    """A forward over two devices (the CPU and ``meta`` stand in for two
    cards): a copy between them is a step of its own between two segments,
    an operation on the other device opens a segment there, and the plan of
    the capture is the plan of the warm-up."""
    card("A")

    def fn(x):
        y = x + 1
        if copy == "to":
            z = y.to(META, non_blocking=True)
        else:
            z = torch.empty(4, device=META)
            z.copy_(y)
        z = z * 2
        return torch.ones(4) + x

    devices = {CPU, META}
    x = torch.arange(4.0)
    # copy_ into a buffer: its allocation is work on the other device.
    want = [("graph", CPU)] + ([("graph", META)] if copy == "copy_" else [])
    want += [("copy", CPU, META, (4,)), ("graph", META), ("graph", CPU)]
    steps, out = compiled.capture_plan(fn, x, devices,
                                       {CPU: "pool", META: "pool"})
    got = compiled._signature(steps)
    warm = compiled._signature(compiled.warm_up_plan(fn, x, devices, 1))
    assert got == warm == want
    assert torch.equal(out, torch.ones(4) + x)


def test_an_op_on_two_devices_is_refused(card):
    card("A")
    with pytest.raises(RuntimeError, match="reads tensors on"):
        compiled.warm_up_plan(lambda x: torch.cat([x, x.to(META)]),
                              torch.zeros(2), {CPU, META}, 1)


def test_split_returns_its_input_outside_a_pass():
    t = torch.arange(3)
    assert compiled.split(t) is t


def _mini_alexnet(b, x, num_classes=10):
    """BinaryAlexNet's packed-domain chain at toy scale
    (tests/test_torch_parallel.py)."""
    x = b.conv_bn(x, 32, 3, stride=2, name="stem")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv2")
    x = b.max_pool(x, 3, 2, padding="VALID")
    x = b.binary_conv_bn(x, 96, 3, pad_value=1, name="conv3")
    x = b.binary_conv_bn(x, 64, 3, pad_value=1, name="conv5")
    x = b.max_pool(x, 2, 2, padding="VALID")
    x = b.flatten(x)
    x = b.binary_dense_bn(x, 128, name="fc1")
    x = b.binary_dense_bn(x, 128, name="fc2")
    x = b.dense(x, num_classes, name="head")
    return b.softmax(x)


@pytest.mark.parametrize("model", ["tiny_quicknet", "mini_alexnet"])
@pytest.mark.parametrize("domain", ["float", "packed"])
def test_segment_plan_equals_eager(card, model, domain):
    """Each data group as segments split at every copy between slots
    (what ``_split_at_slots`` captures), in the float and the packed
    domain: ``torch.equal`` to the eager ``sharded_apply``, over two
    batches alternated."""
    record = card("C")
    if model == "tiny_quicknet":
        spec = tiny_quicknet(**TINY)
        size = (16, 16)
    else:
        spec = ModelSpec("mini_alexnet", _mini_alexnet, input_size=(64, 64),
                         num_classes=10)
        size = (64, 64)
    layers = convert_model(spec, init_model(spec, seed=2, randomize_bn=True))
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    sharded = shard_artifact(prepare_runtime_arrays(layers), mesh)
    groups = partition_layers(sharded, mesh)
    kw = dict(compute_dtype=F32, domain=domain)
    cp = CompiledParts(
        [(lambda x, g=g: group_apply(spec, g, x, **kw), g.home, g.devices,
          "split_at_slots") for g in groups], CPU)
    xs = [torch.from_numpy(parity.images(s, 4, size=size)) for s in (1, 2)]
    for i in range(4):
        want = sharded_apply(spec, sharded, xs[i % 2], mesh, groups=groups,
                             **kw)
        assert torch.equal(cp(xs[i % 2]), want), i
    key = ((4, *size, 3), F32)
    assert cp.host_steps[key] > cp.graphs[key] > len(groups)
    assert len(record["captures"]) == cp.graphs[key]


# -- case C on distinct cards: NCCL, one graph per card ---------------------


def _slots(*cards):
    """``cpu`` slots labelled as the cards named (``cpu:i`` reads as card
    i under ``card("cards")``); their tensors all lie on the CPU."""
    return [torch.device("cpu", i) for i in cards]


def _jax_sharded(dp, tp, x):
    jspec = jtiny_quicknet(**TINY)
    jlayers = jconvert(jspec, jinit(jspec, seed=7, randomize_bn=True))
    return np.asarray(JShardedInterpreter(jspec, jlayers, dp=dp, tp=tp,
                                          compute_dtype=jnp.float32)(x))


@pytest.mark.parametrize("dp, tp", [(1, 2), (2, 2), (1, 4)])
def test_case_c_on_cards_is_one_graph_per_card(card, tiny, dp, tp):
    """Each data group on distinct cards is joined by NCCL and captured as
    one graph per card, all of a group's captures open at once: a call
    replays every card's graph once, so its graphs and host steps are the
    cards' count (2 at (1, 2), 4 at (2, 2) and (1, 4)). Every call, two
    batches alternated, is ``torch.equal`` to the eager ``sharded_apply``
    (copies between slots) and within ``FLOAT32_MODEL_TOL`` of JAX's
    ``ShardedInterpreter``; one communicator set per group, made with the
    interpreter."""
    record = card("cards")
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=dp, tp=tp,
                                   compute_dtype=F32,
                                   devices=_slots(*range(dp * tp)))
    assert interp.case == "C"
    assert [p.plan for p in interp._compiled.parts] == ["per_card"] * dp
    assert [[c.rank for c in comms] for comms in record["comms"]] == [
        list(range(tp))] * dp
    assert len(interp.links) == dp
    xs = [parity.images(s, 4 * dp, size=(16, 16)) for s in (21, 22)]
    outs = [interp(xs[i % 2]) for i in range(4)]
    for i, got in enumerate(outs):
        assert torch.equal(got, _eager(interp, xs[i % 2])), i
    assert not torch.equal(outs[0], outs[1])
    key = ((4 * dp, 16, 16, 3), F32)
    assert interp.plan["graphs"] == {key: dp * tp}
    assert interp.plan["host_steps"] == {key: dp * tp}
    assert len(record["captures"]) == dp * tp
    assert all(mode == "thread_local" for *_, mode in record["captures"])
    assert [g.replays for g in FakeGraph.made] == [4] * (dp * tp)
    parity.assert_outputs_close(outs[0], _jax_sharded(dp, tp, xs[0]),
                                **parity.FLOAT32_MODEL_TOL)


@pytest.mark.parametrize("model", ["tiny_quicknet", "mini_alexnet"])
@pytest.mark.parametrize("domain", ["float", "packed"])
def test_case_c_on_cards_equals_eager_in_both_domains(card, model, domain):
    """The NCCL plan in the bf16 stream, float and packed domain (the packed
    words of a binary layer gathered, a lazy binary stream broadcast):
    ``torch.equal`` to the eager ``sharded_apply`` over two batches
    alternated."""
    card("cards")
    if model == "tiny_quicknet":
        spec, size = tiny_quicknet(**TINY), (16, 16)
    else:
        spec = ModelSpec("mini_alexnet", _mini_alexnet, input_size=(64, 64),
                         num_classes=10)
        size = (64, 64)
    layers = convert_model(spec, init_model(spec, seed=2, randomize_bn=True))
    interp = ds.ShardedInterpreter(spec, layers, dp=1, tp=2, domain=domain,
                                   devices=_slots(0, 1))
    xs = [parity.images(s, 2, size=size) for s in (31, 32)]
    for i in range(4):
        assert torch.equal(interp(xs[i % 2]), _eager(interp, xs[i % 2])), i
    assert interp.plan["host_steps"] == {((2, *size, 3), F32): 2}


def test_no_broadcast_follows_a_gather(card, tiny):
    """The eager forward through the group's NCCL links, logged: each
    all-gather sends every slice to every other slot (copies gather on the
    home slot only), and a sharded layer
    after a gather reads the gathered activation where it lies, so the
    links broadcast less than the copies do, and the output is the
    same."""
    card("cards")
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=1, tp=4,
                                   compute_dtype=F32,
                                   devices=_slots(0, 1, 2, 3))
    x = torch.from_numpy(parity.images(41, 2, size=(16, 16)))
    nccl_log, copies_log = [], []
    group = interp._groups[0]
    got = interp._group_forward(group, x, log=nccl_log)
    want = sharded_apply(spec, interp.layers, x, interp.mesh,
                         groups=interp._groups, log=copies_log,
                         compute_dtype=F32)
    assert torch.equal(got, want)

    def kinds(log, kind):
        return [r for r in log if r["kind"] == kind]

    # Copies: each of 3 slices to the home slot; NCCL: each of 4 to the 3
    # other slots.
    assert len(kinds(nccl_log, "all_gather")) == 4 * len(
        kinds(copies_log, "all_gather"))
    assert 0 < len(kinds(nccl_log, "broadcast")) < len(
        kinds(copies_log, "broadcast"))


def test_a_group_repeating_a_card_keeps_the_segment_plan(card, tiny):
    """NCCL takes one rank per card: a group on cards (0, 0, 1, 1) is
    captured as segments, with no communicator made."""
    record = card("cards")
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=1, tp=4,
                                   compute_dtype=F32,
                                   devices=_slots(0, 0, 1, 1))
    assert interp.case == "C"
    assert [p.plan for p in interp._compiled.parts] == ["segments"]
    assert interp.links == {} and record["comms"] == []
    x = parity.images(42, 2, size=(16, 16))
    for _ in range(2):
        assert torch.equal(interp(x), _eager(interp, x))


def test_nccl_links_take_distinct_cards(card):
    card("cards")
    with pytest.raises(ValueError, match="distinct cards"):
        collective.NcclLinks(_slots(0, 0))


def test_a_failed_per_card_capture_ends_every_capture_and_raises(card, tiny):
    record = card("cards")
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=1, tp=2,
                                   compute_dtype=F32, devices=_slots(0, 1))
    x = parity.images(43, 2, size=(16, 16))
    record["fail"] = "operation not permitted when stream is capturing"
    with pytest.raises(RuntimeError, match="not permitted"):
        interp(x)
    assert standins._state().captures == []
    assert interp.compile_s == {} and interp.plan["graphs"] == {}
    record["fail"] = None
    assert torch.equal(interp(x), _eager(interp, x))


def test_a_copy_between_cards_in_a_per_card_part_is_refused(card):
    """A forward captured as one graph per card must join its cards by NCCL
    only: a copy between two cards in its warm-up raises."""
    card("A")

    def fn(x):
        (x + 1).to(META, non_blocking=True)
        return x * 2

    cp = CompiledParts([(fn, CPU, [CPU, META], "per_card")], CPU)
    with pytest.raises(RuntimeError, match="copies between cards"):
        cp(torch.zeros(4))
    with pytest.raises(ValueError, match="unknown plan"):
        CompiledParts([(fn, CPU, [CPU], "whole")], CPU)


def test_per_card_launch_counts_per_call(card, tiny, monkeypatch):
    """The launches recorded while every card captures are counted once
    per call, whichever card's graph holds them."""
    real = group_apply

    def counting_group_apply(*a, **kw):
        out = real(*a, **kw)
        counts.count(binary_residual_block)
        return out

    monkeypatch.setattr(binary_residual_block, "launches", 0)
    monkeypatch.setattr(ds, "group_apply", counting_group_apply)
    card("cards")
    spec, layers = tiny
    interp = ds.ShardedInterpreter(spec, layers, dp=2, tp=2,
                                   compute_dtype=F32,
                                   devices=_slots(0, 1, 2, 3))
    x = parity.images(44, 4, size=(16, 16))
    for calls in (1, 2, 3):
        interp(x)
        assert binary_residual_block.launches == 2 * calls


def test_a_reshard_gets_new_communicators(card, tiny):
    """MultiHostServer over two hosts of two cards, tp 2: each (2, 2) group
    has its communicators; losing a host builds the survivors' (1, 2)
    interpreter with a new set, and the old interpreter's sets are released
    with it. Every served row equals the eager forward on its mesh."""
    import gc

    record = card("cards")
    spec, layers = tiny
    images = parity.images(46, 8, size=(16, 16))
    with ds.MultiHostServer(spec, layers,
                            host_devices={"h0": _slots(0, 1),
                                          "h1": _slots(2, 3)},
                            tp=2, batch_size=4, max_delay_ms=20,
                            heartbeat_timeout_s=3600,
                            compute_dtype=F32) as server:
        first = server._interp
        assert first.case == "C" and len(record["comms"]) == 2
        rows = [f.result(timeout=WAIT)
                for f in [server.submit(im) for im in images]]
        for i in (0, 4):
            assert np.array_equal(np.stack(rows[i:i + 4]),
                                  _eager(first, images[i:i + 4]).numpy())
        old = [c for comms in record["comms"] for c in comms]
        server.monitor.heartbeat("h0")
        server.monitor._last_seen["h1"] = server.monitor._clock() - 7200
        server.monitor.check_now()
        second = server._interp
        assert second is not first and second.mesh.shape == {"data": 1,
                                                             "model": 2}
        assert len(record["comms"]) == 3
        del first
        rows = [f.result(timeout=WAIT)
                for f in [server.submit(im) for im in images[:4]]]
        assert np.array_equal(np.stack(rows), _eager(second,
                                                     images[:4]).numpy())
        gc.collect()
        assert all(c.released for c in old)
        assert not any(c.released for c in record["comms"][2])
        assert second.plan["host_steps"] == {((4, 16, 16, 3), F32): 2}


# -- MultiHostServer -----------------------------------------------------------


def test_multihost_server_captures_on_its_batcher_thread(card, tiny):
    """The server's interpreter captures at its first batch on the batcher
    thread; after a reshard the new interpreter captures again at its first
    batch; every served row equals the eager forward on the mesh it ran
    on."""
    record = card("A")
    spec, layers = tiny
    images = parity.images(9, 16, size=(16, 16))
    with ds.MultiHostServer(spec, layers,
                            host_devices={"h0": ["cpu"] * 4,
                                          "h1": ["cpu"] * 4},
                            tp=2, batch_size=8, max_delay_ms=20,
                            heartbeat_timeout_s=3600,
                            compute_dtype=F32) as server:
        first = server._interp
        rows = [f.result(timeout=WAIT)
                for f in [server.submit(im) for im in images]]
        batcher = server.engine._thread.name
        assert [c[0] for c in record["captures"]] == [batcher]
        assert first.plan["graphs"] == {((8, 16, 16, 3), F32): 1}
        for i in (0, 8):
            assert np.array_equal(np.stack(rows[i:i + 8]),
                                  _eager(first, images[i:i + 8]).numpy())
        server.monitor.heartbeat("h0")
        server.monitor._last_seen["h1"] = server.monitor._clock() - 7200
        server.monitor.check_now()
        second = server._interp
        assert second is not first and second.mesh.devices.size == 4
        assert second.compile_s == {}
        rows = [f.result(timeout=WAIT)
                for f in [server.submit(im) for im in images[:8]]]
        assert [c[0] for c in record["captures"]] == [batcher] * 2
        assert list(second.compile_s) == [((8, 16, 16, 3), F32)]
        assert np.array_equal(np.stack(rows),
                              _eager(second, images[:8]).numpy())
    assert not server.engine._thread.is_alive()


def test_the_interpreter_goes_with_its_graphs(card, tiny):
    """The graphs hold the interpreter weakly: dropping the interpreter
    frees it (and its graphs) without the garbage collector."""
    import gc
    import weakref

    card("A")
    spec, layers = tiny
    interp = _interp(spec, layers, "A")
    interp(parity.images(10, 8, size=(16, 16)))
    gone = weakref.ref(interp)
    gc.disable()
    try:
        del interp
        assert gone() is None
    finally:
        gc.enable()


# -- timing ---------------------------------------------------------------


def test_time_calls_differences_windows_of_calls(card, monkeypatch):
    """``time_calls``: CUDA-event windows of k and 2k calls (the stand-in
    events hand out the queued times), differenced as ``time_forward``
    does, and the profiler's device time of one call (stubbed: the
    profiler sees no card here); the first call is not timed."""
    from _torch_card_standins import FakeEvent

    from compute_engine_tpu_torch.runtime import benchmark as bm

    calls = []
    monkeypatch.setattr(bm, "device_busy_ms", lambda fn: (fn(), 0.5)[1])
    FakeEvent.queue = [4.0, 8.4, 4.2, 8.0, 4.1, 8.3]
    got = bm.time_calls(lambda x: calls.append(x.shape), torch.zeros(8, 2),
                        iters=2, repeats=3)
    assert got == {**bm.differenced_latency([4.0, 4.2, 4.1],
                                            [8.4, 8.0, 8.3], 2, 8),
                   "device_busy_ms": 0.5}
    assert len(calls) == 1 + 3 * (2 + 4) + 1


@pytest.mark.parametrize("busy_us, want", [
    ([0.0, 900.0], 0.3), ([600.0], 0.2), ([0.0, 0.0], None)])
def test_device_busy_takes_an_empty_trace_again(monkeypatch, busy_us, want):
    """A profiler trace with no device record is taken again, once; two
    empty traces read None."""
    import torch.profiler
    from torch.autograd import DeviceType

    from compute_engine_tpu_torch.runtime import benchmark as bm

    traces = list(busy_us)

    class Row:
        device_type = DeviceType.CUDA

        def __init__(self, us):
            self.self_device_time_total = us

    class Profile:
        def __init__(self, activities):
            self.us = traces.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def key_averages(self):
            return [Row(self.us)]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    got = bm.device_busy_ms(lambda: None, n=3)
    assert got == (None if want is None else pytest.approx(want))
    assert not traces


# -- the scaling report --------------------------------------------------------


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", str(REPO / "scripts" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The port's rows carry the JAX script's keys and these, which say where and
# how each reading was taken.
DP_EXTRAS = {"slots", "case", "latency_ms", "compile_s", "host_steps",
             "device_busy_ms"}
TP_EXTRAS = {"slots", "shape", "kernel", "single_slot_ms",
             "equal_single_slot", "compile_s"}


def test_scaling_report_keys_are_jaxs(monkeypatch):
    """Both scripts with their timers stubbed: the port's ``dp_scaling``
    and ``tp_modes`` rows have the JAX script's keys (and the documented
    extras), one row per dp and per (tp, mode) it takes."""
    jts = _load_jax_script("tp_scaling_report")
    monkeypatch.setattr(jts, "time_call", lambda fn, *a, iters=5: 2e-3)
    jdp, jtp = jts.dp_scaling(), jts.tp_modes()
    monkeypatch.setattr(tsr, "_host_ms", lambda fn, devices, reps: 2.0)
    dp = tsr.dp_scaling(tiny_quicknet(**TINY), per_group=2, dps=(1, 2, 4, 8),
                        device="cpu")
    tp = tsr.tp_modes((8, 6, 6, 64), tps=(2, 8), device="cpu")
    assert [r["dp"] for r in dp] == [r["dp"] for r in jdp]
    for r in dp:
        assert set(r) == set(jdp[0]) | DP_EXTRAS
        assert r["latency_ms"] == 2.0
        assert r["images_per_sec"] == r["batch"] / 2e-3
        assert r["scaling_efficiency"] == pytest.approx(1.0)
    assert [r["mode"] for r in tp if r["tp"] == 8] == [r["mode"] for r in jtp]
    for r in tp:
        assert set(r) == set(jtp[0]) | TP_EXTRAS
        assert r["bit_exact_vs_gather"] and r["equal_single_slot"]
        assert r["latency_ms"] == 2.0
