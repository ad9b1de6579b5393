#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``compute_engine_tpu_torch``) on one
NVIDIA GPU (written for an H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build every CUDA source of the port with nvcc, in parallel.
2. Hold each kernel against its plain PyTorch version on the card,
   ``torch.equal``:
   - the residual block at the shapes QuickNet gives it at batch 128 (the
     7x7 one has blocks that cross image borders), at a ragged channel count
     and at one that is not a multiple of 8 in bfloat16 and float32, with an
     identity transform, with a random transform, and without the residual
     add; and without the add at the shapes of BinaryAlexNet's float-domain
     conv3 and conv5 (256 -> 384 and 384 -> 256 channels);
   - the binary GEMM at the six shapes BinaryAlexNet gives it at batch 128,
     with their output kinds; at KW = 3, at M < 64 and at N = 1000; at a
     ragged shape in all four output kinds with a random transform and
     random thresholds, also with operands that are not 16-byte aligned; in
     its split-K form, forced at a ragged K; and with int8 output at the
     four shapes QuickNet's binary convs give it at batch 128 in the int8
     pipeline (multipliers of both signs); and with float output and a
     folded BN at ReActNet-A's 13 1x1 convs at batch 128
     (``react_pointwise_gemms``: M from 6,272 to 1,605,632 rows, KW 1 to
     32 words, each doubling pair one GEMM of 2C outputs);
   - the exact integer layers of the int8 pipeline (no kernel of the port:
     an im2col and ``torch._int_mm``, shifted int32 products for the
     depthwise conv): the int32 accumulator of each int8 layer of QuickNet,
     with the converted model's int8 kernel, computed on the card equals
     torch's integer conv or matmul on the CPU (the convs at batch 8, the
     head at batch 128), and so does the int8 max pool.
   - the zero-padded residual block (``zero_pad_phase``, from a generator
     of its own) at Bi-RealNet-18's four stride-1 shapes at batches 1, 8
     and 128, in bfloat16 and float32, with and without the add, at a
     ragged and an odd channel count and with C != C_out, in the default
     build and in the debug build;
   - the residual block in place (``dense_compare``): reading a channel
     prefix of a wider buffer and writing its 64 channels into their slot,
     at BinaryDenseNet-45's 40 dense layers at batch 8 (float32 too at each
     block's first and last) and one at batch 128, the whole buffer equal;
   - the stem kernel (``stem_compare``): the 7x7/2 conv and 3x3/2 max pool
     of 224x224x3 images at batches 1, 8 and 128, float32 and bfloat16,
     against its plain version and against the same stem with float64
     sums, every output within one bf16 ulp or, where the sum cancels
     near zero, within what reordering a float32 sum moves it
     (``kernels.stem.within_tolerance``);
   - the transition kernel (``transition_compare``): BinaryDenseNet-45's
     three 1x1 convs and 2x2/2 average pools at batches 1, 3 and 128 and
     on a channel prefix of a wider buffer, against its plain version and
     its float64 sums, within ``kernels.transition.within_tolerance``;
   - the block kernel's ReActNet form (``react_compare``: the threshold in
     the band's signing, the add of x, RPReLU after it) at ReActNet-A's
     five stride-1 3x3 shapes at batches 1, 8 and 128, in the default and
     the debug build;
   ``--compare-only`` stops here. ``--stem-only`` builds, runs the stem
   comparisons in the default and the debug build, passes and trips the
   stem's debug check, times the stem at b128 beside its plain chain and
   cuDNN's conv and PyTorch's pool, drives Bi-RealNet-18,
   BinaryDenseNet-45 and QuickNet b128 through ``Interpreter`` (1, 1 and 0
   stem launches a forward; each forward beside the same with the stem's
   plain version) and stops. ``--zero-pad-only`` builds, runs the
   zero-padded comparisons, times the zero-padded block at Bi-RealNet's
   b128 shapes beside the one-padded block and the lowerings it replaces,
   QuickNet's 16 one-padded blocks per forward, drives Bi-RealNet-18 b128
   through ``Interpreter`` (the launches ``expected_launches`` gives, the
   logits ``torch.equal`` to the plain versions' forward) and stops.
   ``--transition-only`` builds, runs the transition comparisons in the
   default and the debug build, passes and trips the transition's debug
   check, times DenseNet-45's three transitions at b128 beside their plain
   chain and cuDNN's bf16 conv and PyTorch's pool, drives
   BinaryDenseNet-45, QuickNet, Bi-RealNet-18 and MeliusNet-22 b128
   through ``Interpreter`` (3, 0, 0 and 0 transition launches a forward;
   DenseNet-45's forward beside the same with the transition's plain
   version, and its profile) and stops.
   ``--reactnet-only`` builds, holds the block kernel's ReActNet form (the
   threshold in the band's signing, RPReLU after the add) ``torch.equal``
   to its plain version at ReActNet-A's stride-1 3x3 shapes at batches 1, 8
   and 128 in the default and the debug build, times the 9 blocks of a
   b128 forward in that form beside the same blocks without the threshold
   and RPReLU and beside the unfused chain (the shifted input made, the
   conv, the add, the RPReLU), drives ReActNet-A b128 through
   ``Interpreter`` (the launches, thresholded launches and RPReLUs a
   forward; the logits ``torch.equal`` to the same forward with every
   RPReLU unfused; both timed; the fused one profiled) and stops.
   ``--dense-only`` builds, runs the in-place comparisons in both builds
   and QuickNet's and Bi-RealNet's contiguous blocks, times the 40 dense
   layers in place beside their dense-input form, drives
   BinaryDenseNet-45 b128 through ``Interpreter`` with the stream in place
   and concatenated by ``torch.cat`` (launches, logits equal, both timed
   and profiled) and stops.
   ``--sweep-residual`` times the residual
   block at every block size (warps, channel tiles per block) it can be
   launched with, at the QuickNet shapes, and stops: the choice in
   ``kernels/residual.py::_choose_blocks`` rests on it.
   ``--kernel-times`` skips this phase, times the block kernel and the
   GEMM at the main-path shapes as phase 4 does and the stem beside its
   yardsticks, and stops; with ``--root DIR`` it takes the
   package from another checkout, so that two commits are timed on one
   clock, one after the other (the ``*_MS_BEFORE`` constants below were).
3. Drive the main paths, each with the launch counts set to 0 just before
   and read just after, with random weights from seed 0:
   - QuickNet (224x224x3, sections 64/128/256/512, 4+4+4+4 blocks, 1000
     classes) at batch 128, ``init_model -> convert_model ->
     Interpreter.predict``: 16 residual block launches;
   - BinaryAlexNet (224x224x3, 1000 classes) at batch 128 in the packed
     domain, ``init_model -> convert_model -> packed_apply(domain="packed")``:
     6 bgemm launches;
   - QuickNet at batch 128 through the true-int8 pipeline, ``init_model ->
     calibrate_model (two batches of 8) -> convert_model(int8_ranges=,
     int8_out_ranges=) -> packed_apply``: 16 bgemm launches (int8 out), no
     residual block launch, 16 int8 ADDs; its logits equal, ``torch.equal``,
     those of the same forward through the plain GEMM.
   Check each output (finite, probabilities, shape) and its top-1 against
   the same forward through the plain versions on the card; BinaryAlexNet's
   also against its float-domain forward. Then run every zoo model once at
   batch 4 in the float domain, against the plain versions.
3(b). The compiled forward (``--compiled-only`` builds, runs this phase
   alone and stops), from a generator of its own: ``Interpreter`` at
   QuickNet b128 in bf16 and float32, at b1 and in the int8 pipeline, and
   packed BinaryAlexNet b128 through ``runtime.compiled.CompiledForward``:
   the call that captures and a replay, each ``torch.equal`` to the eager
   ``packed_apply`` and at the launches per call ``expected_launches``
   gives; one block's filter negated in place changes the next replay as it
   changes the eager forward; ``predict`` pads its last chunk to a compiled
   shape; a call inside ``kernels.debug_checks()`` raises. Then the eager
   p50 of QuickNet b128, three ``benchmark_model`` readings of it (they
   must lie within 1.05x of each other in images/s, each p50 at most 1.15x
   one compiled QuickNet b128 call alone, timed by CUDA events), and
   QuickNet b1 and packed AlexNet by the same timer beside their eager p50.
   The ``[busy]`` lines read that call two ways side by side, by the
   profiler's device time and by CUDA events, here and once more after
   phase 6, late in the process (where the profiler read short).
4. Time ``benchmark_model`` (images/s) for both models (BinaryAlexNet in both
   domains, QuickNet also with ``int8_pipeline=True``), print a torch.profiler breakdown of each forward's device time
   by kernel, measure the rate of the int8 and the one-bit tensor-core MMA
   (``csrc/mma_rate.cu``), and time each kernel at each main-path shape
   beside its bound, its plain version and a library yardstick, timed only:
   cuDNN's bf16 conv of pre-signed +-1 inputs for the block (and a copy of
   the activation, which moves the same bytes), ``torch._int_mm`` (cuBLAS
   int8) of the unpacked +-1 operands for the GEMM. All of these but the
   GEMM's plain version are timed by replaying a CUDA graph of the calls,
   so that none is timed by how fast the host enqueues it. The ``[time]`` lines also hold each kernel
   against its time before the tensor-core redesign (a constant, with its
   card), and the run fails if a main-path shape is slower than that.

5. The serving path (``--serve-only`` builds, runs this phase alone and
   stops), QuickNet at full width and depth, batch 128:
   - artifact: the graph program of ``tests/fixtures/
     torch_quicknet_graph_program.json`` (the machine with the card has no
     TensorFlow to import a Keras graph with) -> ``spec_from_program`` ->
     ``init_model`` -> ``convert_model`` -> ``save_artifact`` with the program
     in the header; ``Interpreter(artifact_path=)`` with no model named: 16
     block launches, probabilities ``torch.equal`` to the zoo QuickNet's
     ``Interpreter`` on the same weights (carried across by position);
   - cli: ``python3 -m compute_engine_tpu_torch.converter.cli --model quicknet
     --seed 0 --int8-calib-batches 2`` in a subprocess on the card; its
     artifact's forward counts 16 bgemm launches and no block launch;
   - serve: ``ServingEngine`` over that ``Interpreter``: 512 float32 requests
     in full batches (each result equal to its row of the direct forward, 4
     batches, 0 padded slots, 64 block launches); 300 requests from 8 threads
     in bursts (top-1 of each against a direct forward, the stats' sums); an
     ``infer_fn`` that raises once fails that batch's requests only; a uint8
     engine refuses a float32 request; 256 requests through the CLI's int8
     artifact (equal to the direct forward, 32 bgemm launches);
   - ``evaluate`` over synthetic batches, ``detection_postprocess`` on the
     card against itself on the CPU, ``native_bitpack`` against numpy;
   - times: requests/s, request latency p50/p99, batch fill and the split of a
     served batch (host stack, host->device, forward, device->host) for
     float32 and uint8 requests, ``benchmark_model``'s images/s beside them.

6. Selection, ``kernel=`` and brief training, at full width:
   - select (``--select-only`` builds and runs this part alone): the
     planner (``kernels.autotune.plan``/``measure``, table left unchanged)
     at batch 128 over every binary layer shape of QuickNet and
     BinaryAlexNet, in each domain and output kind the runtime consults;
     every candidate's output must equal the GEMM lowering's before it is
     timed. One ``[select]`` line per shape: each candidate's ms, the winner
     and the committed table's choice (not gated);
   - ``kernel=``: QuickNet b128 through ``Interpreter(kernel=k)`` for "auto",
     "residual", "bgemm", "mxu" and "s2d", packed BinaryAlexNet b128 through
     ``packed_apply(kernel=k)`` for "auto", "bgemm" and "mxu": top-1 equal to
     the plain-version forward on 128/128 images, "auto" launching what the
     committed table says; ``benchmark_model(kernel=k)``'s images/s and the
     profiler's device-busy time; ``benchmark_model(artifact_path=)`` on
     phase 5's artifact reports its memory;
   - train (``--train-only [--models a,b]`` alone): QuickNet,
     Bi-RealNet-18, BinaryAlexNet and BinaryDenseNet-28 at 224x224 (16, 8,
     8 and 8 classes on the 1000-wide head) trained on the card by
     ``compute_engine_tpu_torch.scripts.accuracy_fixtures`` (the protocol of
     the JAX repo's ``scripts/make_accuracy_fixtures.py``: 250, 250, 650 and
     250 steps of batch 32, DenseNet's gradients clipped to global norm 1.0,
     precise BN over 16 batches of 64, calibration on one batch of 32;
     first, two trainings of 3 steps from one seed must end in the same
     weights bit for bit), then
     the float oracle against the packed float32, bfloat16, int8 and
     packed-domain paths over 512 images, each path against the oracle at
     its own operand precision (float32, else bfloat16 operands in the
     oracle's float convs and dense layers, as on the TPU where the gates
     were set), gated by the JAX package's per-model bounds
     (``accuracy_fixtures.GATES``); the agreement with the float32 oracle
     is printed beside. Each record is one
     ``accuracy_224`` JSON line (tests/fixtures/torch_accuracy_224.json holds
     the records);
   - the float32 QuickNet forward (TF32 off in the call) timed beside the
     bfloat16 one.
   Phases 3 and 5 gate the launch counts of the "auto" forward at what the
   committed table chooses (``expected_launches``).

7. The multi-device path (``--multi-only`` builds and runs this phase
   alone; the default run runs it so, in a process of its own), from a
   generator of its own. A mesh takes distinct cards where
   the visible ones cover it, else ``cuda:0`` repeated (each line says
   which):
   - ``tp_bconv2d`` at QuickNet's b128 shapes 14x14x256 and 7x7x512 over 2
     and 4 slots: "gather" and "sharded" with float and bitpacked output,
     "pipelined" with float, int8 and bitpacked; each ``torch.equal`` to the
     single-slot ``ops.bconv2d`` with the GEMM lowering, with the kernel and
     again with the plain GEMM on the shards, at the launches
     ``layer_launches`` gives at the shard shape; "pipelined" issues ring
     copies and no all-gather. The block kernel at every QuickNet shape
     with a slot's share of the output channels, against its plain version;
   - ``ShardedInterpreter``, compiled (``runtime.compiled.CompiledParts``:
     case A, one graph, where every slot is one card; B, a graph per data
     group, where each group is one card; C, where a group spans cards: on
     distinct cards NCCL all-gathers and broadcasts inside one graph per
     card, so that a call's host steps are the cards' count), QuickNet
     224x224 b128, meshes (2, 1), (1, 2), (2, 2) (and (4, 1), (1, 4) with
     four cards) at float32 (top-1 128/128 and max |dprob| <= 1e-5 against
     ``Interpreter``) and bf16 (printed), each with the bytes its
     transfers between slots move per call (the eager forward's log);
     case C on cards under a time limit of its own, so that a replay whose
     peers never meet fails the run;
     the segment plan on one card (``_split_at_slots``) at (1, 2) bf16;
     packed BinaryAlexNet b128 at (1, 2), top-1 128/128 against
     ``packed_apply(domain="packed")``. Each: launches per call, over three
     calls, as ``expected_sharded_launches`` derives them at the shard
     shapes; ``torch.equal`` to the eager ``sharded_apply`` with the
     kernels and with the plain versions; two batches alternated over four
     calls, each equal to its eager forward, with the allocated memory
     not grown; one slot's shard of a filter negated in place changes the
     next call as it changes the eager forward (QuickNet); one graph and
     one host step per call on a one-card mesh. In bf16 the eager p50, the
     compiled p50 (``benchmark.time_calls``: differenced windows of 20 and
     40 calls, median of 5), images/s, the device busy of one call (the
     profiler), one call alone (CUDA events) and ``compile_s``, also in
     float32 for case C on cards; on one card p50 <= 1.15x one call alone;
   - ``MultiHostServer`` over hosts h0 (slots 0-1) and h1 (slots 2-3), tp
     2, batch 128: 512 requests equal to the direct forward on its mesh; h1
     lost, one reshard to two slots, 128 requests top-1 128/128 against
     ``Interpreter``; h1 back, four slots, 128 requests equal to the first
     mesh's; each mesh compiled once, at its first batch on the batcher
     thread; the memory allocated after two reshards within 5% of before;
   - ``launch_workers`` on the card (NCCL on two cards, else a one-rank
     NCCL group and a two-rank Gloo group on ``cuda:0``), each rank's
     forward compiled: every rank's output within 1e-5 of the
     single-process float32 ``packed_apply``;
   - the kernels' debug builds (``kernels.debug_checks()``): silent and equal
     to the default build at the main-path shapes; each of the four checks
     trips on a deliberately broken call by raising, and the default build
     still gives its results afterwards;
   - the entry points of ``__graft_entry_torch__.py``: ``entry()`` (QuickNet
     b8 zeros through the compiled ``Interpreter``, ``torch.equal`` to the
     eager ``packed_apply``) and ``dryrun_multichip(n)`` for 2 slots (and
     4 where four cards are visible: case C at (2, 2) over NCCL), under the
     time limit of case C.

8. The repo's tools (``--tools-only`` builds and runs this phase alone):
   - ``examples.e2e_smoke``: ``quantize`` -> ``bconv2d`` with "reference",
     "bgemm" and "mxu" -> the bitpacked chain -> ``bmaxpool2d`` ->
     ``dequantize``; every lowering ``torch.equal`` to "reference";
   - ``scripts.baseline_matrix`` at QuickNetSmall b1, QuickNet b128,
     QuickNetLarge b128, Bi-RealNet-18 b128 (latency, images/s, device busy
     per forward) and BinaryDenseNet-45 served for 10 s from 256 closed-loop
     clients (every result equal to the direct forward); every row finite
     and positive;
   - ``scripts.section_profile`` at b128, in a process of its own: every
     section's device time positive and its share of its bound at most
     105%;
   - ``scripts.tp_scaling_report``: the compiled ``ShardedInterpreter``
     on QuickNet at dp 1, 2, 4 and ``tp_bconv2d``'s three modes at 2 and 4
     slots of one card, each captured into a graph, each equal to one slot
     and to the gather mode.

The last lines are the ``kernels`` JSON object, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA device, or outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor-core ops/s.
# The data sheet gives no one-bit rate. The one-bit MMA covers eight times
# the K of the int8 one and issues at the same rate (phase 4 measures both,
# the ``[mma]`` lines), so the peak for one-bit operands is eight times the
# int8 peak; the kernels' operations are held against that.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_ONE_BIT_OPS_PER_S = 8 * PEAK_INT8_OPS_PER_S

QUICKNET_BLOCKS = [(128, 56, 56, 64), (128, 28, 28, 128), (128, 14, 14, 256),
                   (128, 7, 7, 512)]
# Times (ms) of the xor-popcount kernels on the CUDA cores that these kernels
# replaced: ``--kernel-times --root`` on a checkout of the commit before the
# redesign, by CUDA-graph replay like the times they are held against.
BEFORE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
BLOCK_MS_BEFORE = {56: 0.4771, 28: 0.3613, 14: 0.3062, 7: 0.3197}
GEMM_MS_BEFORE = {"conv2": 0.6032, "conv3": 0.2183, "conv4": 0.2892,
                  "conv5": 0.2017, "fc1": 0.0537, "fc2": 0.0253}
SPLITK_MS_BEFORE = 0.0102
RAGGED = (4, 9, 9, 48)
# Bi-RealNet-18's 3x3 stride-1 zero-padded binary convs: (h, w, c), three
# or four of each a forward, 13 in all.
BIREAL_BLOCKS = [(56, 56, 64), (28, 28, 128), (14, 14, 256), (7, 7, 512)]
BIREAL_BLOCK_COUNTS = (4, 3, 3, 3)
ZERO_PAD_BATCHES = (1, 8, 128)
ODD = (3, 6, 5, 20)  # channels not a multiple of 8: no 16-byte access
BLOCKS_PER_SHAPE = 4  # QuickNet: 4 blocks in each of the four sections
# BinaryDenseNet-45's dense blocks: (height = width, channels entering,
# layers), each layer 64 channels more; the stream lies in one buffer as
# wide as the block's final width (448, 928, 1152, 800).
DENSE_BLOCKS = [(56, 64, 6), (28, 160, 12), (14, 256, 14), (7, 288, 8)]
DENSE_GROWTH = 64
DENSE_B128 = (56, 384, 448)  # the b128 case: block 0's last layer
# The float stem of Bi-RealNet-18 and the BinaryDenseNets: 224x224x3 images,
# a 7x7/2 conv to 64 channels, a 3x3/2 max pool (``kernels/stem.py``).
STEM_IMAGE = (224, 224, 3)
STEM_KERNEL = (7, 7, 3, 64)
STEM_BATCHES = (1, 8, 128)
# Launches of the stem kernel a forward, by zoo model.
STEM_LAUNCHES = {"birealnet18": 1, "binary_densenet45": 1, "quicknet": 0}
# BinaryDenseNet-45's float transitions (``kernels/transition.py``): (height
# = width, C_in, C_out) of the 1x1 conv before each 2x2/2 average pool.
TRANSITIONS = ((56, 448, 160), (28, 928, 256), (14, 1152, 288))
TRANSITION_BATCHES = (1, 3, 128)
TRANSITION_PREFIX = 64  # channels after the stream in the wider buffer
# Launches of the transition kernel a forward, by zoo model.
TRANSITION_LAUNCHES = {"binary_densenet45": 3, "quicknet": 0,
                       "birealnet18": 0, "meliusnet22": 0}
TOLERANCE = "torch.equal (bit for bit)"

# BinaryAlexNet's binary GEMMs at batch 128 in the packed domain:
# (layer, M, KW, N, output kind).
ALEXNET_GEMMS = [
    ("conv2", 128 * 27 * 27, 25 * 3, 256, "bitpacked"),
    ("conv3", 128 * 13 * 13, 9 * 8, 384, "bitpacked"),
    ("conv4", 128 * 13 * 13, 9 * 12, 384, "bitpacked"),
    ("conv5", 128 * 13 * 13, 9 * 12, 256, "bitpacked"),
    ("fc1", 128, 288, 4096, "bitpacked"),
    ("fc2", 128, 128, 4096, "float"),
]
ALEXNET_FLOAT_CONVS = [((128, 13, 13, 256), 384), ((128, 13, 13, 384), 256)]
# QuickNet's binary convs at batch 128 in the int8 pipeline, four per
# section, int8 out: (section, M, KW, N).
QUICKNET_INT8_GEMMS = [
    ("section_0", 128 * 56 * 56, 9 * 2, 64),
    ("section_1", 128 * 28 * 28, 9 * 4, 128),
    ("section_2", 128 * 14 * 14, 9 * 8, 256),
    ("section_3", 128 * 7 * 7, 9 * 16, 512),
]
RAGGED_GEMM = (1000, 77, 100)
# (label, M, KW, N, output kind): a 1x1 conv of 96 channels (KW = 3), fewer
# rows than a tile, and N = 1000 (not a multiple of the 64-column tile).
EDGE_GEMMS = [
    ("1x1 conv of 96 channels", 128 * 13 * 13, 3, 256, "float"),
    ("1x1 conv of 96 channels", 128 * 13 * 13, 3, 256, "bitpacked"),
    ("M < 64", 40, 77, 100, "int8"),
    ("M < 64", 40, 72, 96, "bitpacked"),
    ("N = 1000", 128, 128, 1000, "float"),
    ("N = 1000", 3000, 75, 1000, "bitpacked"),
]
SERVE_BATCH = 128  # the served batch; requests come in multiples of it
SPLITK_BLOCK_KW = 32  # forces 3 blocks of K at KW = 77, the last ragged


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warm=2, graph=True):
    """Milliseconds per call of ``fn`` on the card: the CUDA-graph replay of
    ``reps`` calls timed by CUDA events (``runtime.microbench.time_ms``);
    ``graph=False`` times eager calls."""
    from compute_engine_tpu_torch.runtime.microbench import time_ms as timed

    return timed(fn, reps, warm=warm, graph=graph)


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def profile_forward(forward, n=3, top=12):
    """Device time per forward by kernel, from a torch.profiler trace of
    ``n`` forwards (informational: it checks nothing). Prints the ``top``
    kernels and returns the device-busy ms per forward (None when the
    profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("[profile] the profiler saw no device time: not measured")
        return None
    busy = sum(r[0] for r in rows)
    if top:
        print(f"[profile] per forward under the profiler: device busy "
              f"{busy:.3f} ms of {wall_ms:.3f} ms wall, idle share "
              f"{1 - busy / wall_ms:.3f}")
    for ms, count, name in rows[:top]:
        print(f"[profile] {ms:8.4f} ms {count:5.1f}x {name[:100]}")
    return busy


def block_case(rng, shape, device, dtype, identity, c_out=None):
    """Inputs of one residual block: x (with exact +0.0 and -0.0 entries),
    the packed +-1 filter (``c_out`` output channels, as many as input
    channels by default) and a fused transform."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.core import bitpack_np, fuse_output_transform

    n, h, w, c = shape
    co = c if c_out is None else c_out
    x = rng.normal(0, 1, shape).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    x.reshape(-1)[1::89] = -0.0
    filt = rng.choice([-1.0, 1.0], size=(co, 3, 3, c)).astype(np.float32)
    if identity:
        post_mul, post_bias = np.ones(co), np.zeros(co)
    else:
        post_mul = (rng.uniform(0.1, 2.0, co)
                    * rng.choice([-1.0, 1.0], co)).astype(np.float32)
        post_bias = rng.uniform(-5, 5, co).astype(np.float32)
    tr = fuse_output_transform(post_mul, post_bias, 9 * c)
    tr = type(tr)(clamp_min=tr.clamp_min, clamp_max=tr.clamp_max,
                  multiplier=torch.from_numpy(tr.multiplier).to(device),
                  bias=torch.from_numpy(tr.bias).to(device))
    pf = torch.from_numpy(bitpack_np(filt).view(np.int32)).to(device)
    xt = torch.from_numpy(x).to(device).to(dtype).contiguous()
    return xt, pf, tr


def block_work(shape):
    """Bytes and operations of one block: bf16 x read and out written once,
    filter words and transform read once; 2 * 9 * C one-bit operations per
    output."""
    n, h, w, c = shape
    nbytes = 2 * n * h * w * c * 2 + c * 9 * (-(-c // 32)) * 4 + 2 * c * 4
    return nbytes, 2 * n * h * w * c * 9 * c


def bound(nbytes, ops):
    """Least time (ms) for the work and what sets it, against the H100's
    memory rate and its tensor-core rate for one-bit operands."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_ONE_BIT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_case(rng, m, kw, n, kind, device, n_major=True):
    """Random operands of one binary GEMM: lhs (M, KW) words, rhs (KW, N)
    words (the transposed view of an (N, KW) filter, as the path passes it,
    or a contiguous (KW, N) tensor) and the epilogue arguments of ``kind``."""
    import numpy as np
    import torch

    def words(shape):
        return torch.from_numpy(
            rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
            .view(np.int32)).to(device)

    lhs = words((m, kw))
    rhs = words((n, kw)).t() if n_major else words((kw, n))
    kwargs = {"out_kind": kind}
    if kind == "bitpacked":
        kwargs["thresholds"] = torch.from_numpy(rng.integers(
            16 * kw - 40, 16 * kw + 40, n).astype(np.int32)).to(device)
    elif kind in ("float", "int8"):
        scale = 4.0 if kind == "int8" else 1.0
        kwargs.update(
            multiplier=torch.from_numpy((rng.uniform(-1, 1, n) * scale / kw)
                                        .astype(np.float32)).to(device),
            bias=torch.from_numpy(rng.normal(0, 3, n).astype(np.float32))
            .to(device),
            clamp_min=-20 * kw + 7, clamp_max=30 * kw - 3)
    return lhs, rhs, kwargs


def bn_gemm_case(rng, m, kw, n, device):
    """Random operands of a 1x1 binary conv's GEMM as the packed path runs
    it (``kernels/bconv2d.py`` ``bconv2d_bgemm``): lhs (M, KW) words, rhs
    the transposed view of an (N, KW) filter, and the float epilogue of a
    BN folded by ``fuse_output_transform`` over K = 32 KW bits, clamps
    included."""
    import torch

    from compute_engine_tpu_torch.core.transforms import (
        fuse_output_transform)

    lhs, rhs, _ = gemm_case(rng, m, kw, n, "accum", device)
    t = fuse_output_transform(rng.uniform(-2, 2, n), rng.normal(0, 3, n),
                              32 * kw)
    return lhs, rhs, {
        "out_kind": "float", "clamp_min": t.clamp_min,
        "clamp_max": t.clamp_max,
        "multiplier": torch.as_tensor(t.multiplier).to(device),
        "bias": torch.as_tensor(t.bias).to(device)}


def gemm_work(m, kw, n, kind):
    """Bytes and operations of one binary GEMM: packed lhs and rhs read
    once, the epilogue vectors read once, the output written once (a word
    per 32 columns bitpacked, one byte per value for int8, else four);
    2 * M * N * 32 * KW one-bit operations."""
    out = (4 * m * -(-n // 32) if kind == "bitpacked"
           else m * n if kind == "int8" else 4 * m * n)
    vectors = 4 * n if kind == "bitpacked" else 8 * n
    return 4 * m * kw + 4 * n * kw + vectors + out, 2 * m * n * 32 * kw


def sweep_residual(rng, device, card):
    """Time the residual block at each QuickNet shape with every number of
    warps and of channel tiles per block, each held against the plain
    version, and print which ``plan_residual_block`` chooses."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.kernels import residual

    choose = residual.plan_residual_block
    for shape in QUICKNET_BLOCKS + [(128, 7, 7, 64)]:
        c = shape[-1]
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        x, pf, tr = block_case(rng, shape, device, torch.bfloat16, False)
        want = residual.binary_residual_block_plain(x, pf, tr, p)
        chosen = choose(*shape, c)
        for warps in (8, 4, 2):
            for tiles in (1, 2, 4, 8):
                if tiles > -(-c // 64):
                    continue

                def run(block=(warps, tiles)):
                    return residual._launch(x, pf, tr, True, block=block)

                check(torch.equal(run(), want), f"sweep {shape} {warps} "
                      f"warps, {tiles} tiles: kernel != plain")
                ms = time_ms(run, reps=50)
                mark = (" <- chosen" if (warps, tiles) == (
                    chosen["warps"], chosen["tiles_per_block"]) else "")
                print(f"[sweep] residual_block {'x'.join(map(str, shape))} "
                      f"bf16, {warps} warps, {tiles} channel tile(s) per "
                      f"block, {choose(*shape, c, 2, warps, tiles)['blocks']}"
                      f" blocks: {ms:.4f} ms [{card}]{mark}", flush=True)


def time_block(rng, shape, device, yardsticks=True):
    """Times of the residual block at one bf16 shape, all by CUDA-graph
    replay: the kernel and, with ``yardsticks``, its plain version, cuDNN's
    bf16 conv of pre-signed inputs and a copy of the activation; and its
    bound."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding, bitunpack
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    c = shape[-1]
    p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
    x, pf, tr = block_case(rng, shape, device, torch.bfloat16, False)
    bound_ms, bound_by = bound(*block_work(shape))
    times = {"shape": list(shape),
             "ms": time_ms(lambda: binary_residual_block(x, pf, tr, p),
                           reps=50),
             "bound_ms": bound_ms, "bound_by": bound_by}
    if not yardsticks:
        return times
    # The plain version gets the filter unpacked once, as on the main path
    # (prepare_runtime_arrays).
    upf = bitunpack(pf, c, dtype=torch.int8).permute(1, 2, 3, 0)
    times["plain_ms"] = time_ms(
        lambda: binary_residual_block_plain(x, pf, tr, p,
                                            unpacked_filter=upf),
        reps=3, warm=1)
    xs = torch.where(x < 0, -1.0, 1.0).to(torch.bfloat16)
    xs = xs.permute(0, 3, 1, 2)  # channels_last NCHW view
    ws = torch.from_numpy(rng.choice([-1.0, 1.0], size=(c, c, 3, 3))).to(
        device, torch.bfloat16)
    times["library_ms"] = time_ms(
        lambda: torch.nn.functional.conv2d(xs, ws, padding=1), reps=50)
    times["copy_ms"] = time_ms(lambda: x.clone(), reps=50)
    return times


def time_gemm(rng, m, kw, n, kind, device, max_block_kw=1024,
              yardsticks=True):
    """Times of the binary GEMM at one shape: the kernel by CUDA-graph
    replay and by eager calls (``ms_enqueued_from_python``, which the host's
    enqueue rate sets for the short shapes) and, with ``yardsticks``,
    ``torch._int_mm`` of unpacked +-1 int8 operands by graph replay (N
    padded to a multiple of 8, which it needs; the record says so) and the
    plain version by eager calls (it copies a scalar from the host, which a
    capture refuses; it takes 0.7 ms and more in a dozen launches, so the
    host does not set its time); and its bound."""
    import torch

    from compute_engine_tpu_torch.kernels.bgemm import bgemm, bgemm_plain

    lhs, rhs, kwargs = gemm_case(rng, m, kw, n, kind, device)

    def run():
        return bgemm(lhs, rhs, max_block_kw=max_block_kw, **kwargs)

    bound_ms, bound_by = bound(*gemm_work(m, kw, n, kind))
    times = {"shape": [m, kw, n], "out_kind": kind,
             "ms": time_ms(run, reps=20),
             "ms_enqueued_from_python": time_ms(run, reps=20, graph=False),
             "bound_ms": bound_ms, "bound_by": bound_by}
    if not yardsticks:
        return times
    times["plain_ms"] = time_ms(lambda: bgemm_plain(lhs, rhs, **kwargs),
                                reps=3, warm=1, graph=False)
    times["library_ms"] = None
    if m > 16:  # torch._int_mm takes M > 16 and N % 8 == 0: N is padded
        n8 = -(-n // 8) * 8
        a8 = torch.randint(0, 2, (m, 32 * kw), device=device,
                           dtype=torch.int8) * 2 - 1
        b8 = (torch.randint(0, 2, (n8, 32 * kw), device=device,
                            dtype=torch.int8) * 2 - 1).t()
        times["library_ms"] = time_ms(lambda: torch._int_mm(a8, b8), reps=20)
        if n8 != n:
            times["library_n_padded_to"] = n8
    return times


def kernel_times(rng, device, card):
    """The kernels alone at the main-path shapes, without yardsticks; the
    block kernel's time a b128 forward of QuickNet (16 blocks), of
    Bi-RealNet-18 (13 zero-padded blocks with their adds) and of
    BinaryDenseNet-45 (40 dense layers on dense inputs); the stem kernel
    at b128 beside its plain chain and the library's conv and pool, and
    DenseNet-45's three transitions likewise (a checkout without a kernel
    times its chain alone)."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    quicknet_ms = 0.0
    for shape in QUICKNET_BLOCKS:
        t = time_block(rng, shape, device, yardsticks=False)
        quicknet_ms += BLOCKS_PER_SHAPE * t["ms"]
        print(f"[kernel-times] residual_block {'x'.join(map(str, shape))} "
              f"bf16: {t['ms']:.4f} ms [{card}]", flush=True)
    birealnet_ms = 0.0
    for (h, w, c), count in zip(BIREAL_BLOCKS, BIREAL_BLOCK_COUNTS):
        x, pf, tr = block_case(rng, (128, h, w, c), device, torch.bfloat16,
                               False)
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=0)
        delta = zero_padding_tap_delta(pf, p)
        birealnet_ms += count * time_ms(
            lambda: binary_residual_block(x, pf, tr, p, tap_delta=delta),
            reps=50)
    print(f"[kernel-times] residual_block a b128 forward: QuickNet's 16 "
          f"{quicknet_ms:.4f} ms, Bi-RealNet-18's 13 zero-padded "
          f"{birealnet_ms:.4f} ms, BinaryDenseNet-45's 40 on dense inputs "
          f"{dense_layer_times(rng, device, in_place=False):.4f} ms "
          f"[{card}]", flush=True)
    m, kw, n = RAGGED_GEMM
    for name, m, kw, n, kind, block_kw in (
            [g + (1024,) for g in ALEXNET_GEMMS]
            + [("split-K", m, kw, n, "float", SPLITK_BLOCK_KW)]
            + [(f"QuickNet int8 {g[0]}", *g[1:], "int8", 1024)
               for g in QUICKNET_INT8_GEMMS]):
        t = time_gemm(rng, m, kw, n, kind, device, block_kw, yardsticks=False)
        print(f"[kernel-times] bgemm {name} M={m} KW={kw} N={n} {kind}: "
              f"{t['ms']:.4f} ms; enqueued from Python "
              f"{t['ms_enqueued_from_python']:.4f} ms [{card}]", flush=True)
    stem_times(rng, device, card)
    transition_times(device, card)


def int8_quicknet(device, seed=0):
    """QuickNet calibrated and converted for the true-int8 pipeline as
    ``benchmark_model(int8_pipeline=True)`` does it: random weights from
    ``seed``, two calibration batches of 8 from ``seed + 1``. Returns the
    spec, the float parameters and the int8 artifact layers (numpy)."""
    import numpy as np

    from compute_engine_tpu_torch.models import (calibrate_model,
                                                 convert_model, get_model,
                                                 init_model)

    spec = get_model("quicknet")
    params = init_model(spec, seed=seed, randomize_bn=True)
    crng = np.random.default_rng(seed + 1)
    in_r, out_r = calibrate_model(
        spec, params,
        [crng.normal(0, 1, (8, *spec.input_size, 3)).astype(np.float32)
         for _ in range(2)], with_outputs=True, device=device)
    return spec, params, convert_model(spec, params, int8_ranges=in_r,
                                       int8_out_ranges=out_r)


def compare_integer_layers(rng, layers, device):
    """Each int8 layer of QuickNet, with its converted int8 kernel and a
    random int8 input of the shape the forward gives it: the int32
    accumulator computed on the card equals torch's integer conv or matmul
    on the CPU. So does the int8 max pool of the transitions."""
    import torch
    import torch.nn.functional as F

    from compute_engine_tpu_torch.models import layers as L

    def int8(shape):
        return torch.from_numpy(rng.integers(-127, 128, size=shape,
                                             dtype="int8"))

    def on_cpu(x, k, stride, groups=1):
        xn = L._same_pad(x.permute(0, 3, 1, 2).to(torch.int32), k.shape[:2],
                         stride, (1, 1), value=0)
        kn = k.to(torch.int32)
        kn = (kn.permute(2, 3, 0, 1) if groups > 1
              else kn.permute(3, 2, 0, 1))
        return F.conv2d(xn, kn, stride=stride, groups=groups).permute(
            0, 2, 3, 1)

    cases = [("stem_conv", (8, 224, 224, 3)),
             ("stem_depthwise", (8, 112, 112, 16)),
             ("stem_pointwise", (8, 56, 56, 16)),
             ("transition_1", (8, 28, 28, 64)),
             ("transition_2", (8, 14, 14, 128)),
             ("transition_3", (8, 7, 7, 256)),
             ("head", (128, 512))]
    for name, shape in cases:
        entry = layers[name]
        k = torch.from_numpy(entry["kernel_int8"])
        x = int8(shape)
        if entry["kind"] == "dense":
            got = L.dense_int8(x.to(device), k.to(device))
            want = x.to(torch.int32) @ k.to(torch.int32)
        elif entry["kind"] == "depthwise_conv":
            stride = tuple(entry["stride"])
            got = L.depthwise_conv2d_int8(x.to(device), k.to(device), stride)
            want = on_cpu(x, k, stride, groups=shape[-1])
        else:
            stride = tuple(entry["stride"])
            got = L.conv2d_int8(x.to(device), k.to(device), stride)
            want = on_cpu(x, k, stride)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.is_cuda
              and torch.equal(got.cpu(), want),
              f"int8 layer {name} {shape}: the card's int32 accumulator != "
              "the CPU's")
        print(f"[compare] int8 layer {name} {'x'.join(map(str, shape))} x "
              f"{'x'.join(map(str, k.shape))}: int32 accumulator on the card "
              f"equals the CPU's integer {entry['kind']} ({TOLERANCE}), "
              f"max |acc| {int(want.abs().max())}", flush=True)
    x = -int8((8, 56, 56, 64)).abs() - 1  # all negative: padding must not win
    for pool, stride, padding in ((2, 2, "SAME"), (3, 2, "SAME")):
        got = L.max_pool(x.to(device), (pool, pool), (stride, stride), padding)
        want = L.max_pool(x, (pool, pool), (stride, stride), padding)
        check(got.dtype == torch.int8 and torch.equal(got.cpu(), want)
              and int(want.max()) < 0,
              f"int8 max pool {pool}x{pool}/{stride}: card != CPU")
        print(f"[compare] int8 max pool {pool}x{pool}/{stride} {padding} "
              f"8x56x56x64: equal to the CPU's ({TOLERANCE})", flush=True)


def max_abs_diff(got, want):
    return (got.double() - want.double()).abs().max().item()


def percentile(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q / 100 * len(values)))]


def serve(engine, images, submitters=1, burst=None, seed=0):
    """Submit ``images`` to ``engine`` and wait for every result: in order
    from one thread, or, with ``burst=(most images, longest pause in s)``, in
    random bursts from ``submitters`` threads, image ``i`` by thread ``i %
    submitters``. Returns the results in the images' order, each request's
    latency (submit to resolved, s) and the wall time of the whole run."""
    import threading

    import numpy as np

    n = len(images)
    futures, submitted, resolved = [None] * n, [0.0] * n, [0.0] * n

    def note(i):
        return lambda fut: resolved.__setitem__(i, time.perf_counter())

    def submitter(t):
        rng = np.random.default_rng(seed + t)
        mine = list(range(t, n, submitters))
        while mine:
            k = int(rng.integers(1, burst[0] + 1)) if burst else len(mine)
            for i in mine[:k]:
                submitted[i] = time.perf_counter()
                futures[i] = engine.submit(images[i])
                futures[i].add_done_callback(note(i))
            mine = mine[k:]
            if burst and mine:
                time.sleep(float(rng.uniform(0, burst[1])))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "a submitter hangs")
    results = [f.result(timeout=600) for f in futures]
    wall = max(resolved) - t0
    return results, [r - s for r, s in zip(resolved, submitted)], wall


def serving_phase(root, dev, card, bench_images_per_s, tmp):
    """Phase 5: convert -> self-contained artifact -> Interpreter ->
    ServingEngine, with the CLI, evaluate, detection and the native host
    library. The artifacts go to ``tmp``. Returns the launch counts of its
    paths and the self-contained artifact's path.

    The (block, bgemm, split-K) launches of a float QuickNet forward are
    what the committed selection table gives (``expected_launches``)."""
    import dataclasses

    import numpy as np
    import torch

    from compute_engine_tpu_torch.converter import (save_artifact,
                                                    spec_from_program)
    from compute_engine_tpu_torch.kernels.bgemm import bgemm
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.ops import detection_postprocess
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.evaluate import (evaluate,
                                                           synthetic_batches)
    from compute_engine_tpu_torch.runtime.serving import ServingEngine
    from compute_engine_tpu_torch.utils.native import get_lib, native_bitpack

    def reset():
        binary_residual_block.launches = 0
        bgemm.launches = bgemm.splitk_launches = 0

    def counts():
        return (binary_residual_block.launches, bgemm.launches,
                bgemm.splitk_launches)

    B = SERVE_BATCH
    launches = {}
    rng = np.random.default_rng(5)
    qn = expected_launches("quicknet", B)

    def times(k):
        return tuple(k * v for v in qn)

    print(f"[serve] a float QuickNet batch-{B} forward launches "
          f"(block, bgemm, split-K) {qn} under the committed table",
          flush=True)

    # artifact: the committed graph program -> a self-contained artifact.
    t0 = time.perf_counter()
    with open(os.path.join(root, "tests", "fixtures",
                           "torch_quicknet_graph_program.json")) as f:
        fixture = json.load(f)
    gspec = spec_from_program(fixture["program"],
                              input_size=fixture["input_size"],
                              num_classes=fixture["num_classes"],
                              name="quicknet_graph")
    glayers = convert_model(gspec, init_model(gspec, seed=0,
                                              randomize_bn=True))
    check(list(glayers) == [name for name, _ in fixture["params"]],
          "the program's layers are not the fixture's, in its order")
    path = os.path.join(tmp, "quicknet_graph.npz")
    save_artifact(path, glayers, gspec.name, {
        "source": "random(seed=0)", "int8": False,
        "input_size": fixture["input_size"],
        "num_classes": fixture["num_classes"],
        "graph_program": fixture["program"]})
    del gspec, glayers
    interp = Interpreter(artifact_path=path, device=dev)  # only the path from here on
    check(interp.spec.name == "quicknet_graph"
          and interp.spec.forward.program["ops"] == fixture["program"]["ops"],
          "the interpreter's spec is not the artifact's program")
    # The zoo's QuickNet from the same seed draws the same weights in the
    # same order; hold them equal by position, then the outputs.
    zoo = get_model("quicknet")
    zlayers = convert_model(zoo, init_model(zoo, seed=0, randomize_bn=True))
    zinterp = Interpreter(zoo, zlayers, device=dev)
    check(len(zlayers) == len(interp.layers), "layer counts differ")
    for zname, gname in zip(zinterp.layers, interp.layers):
        for key, zv in zinterp.layers[zname].items():
            gv = interp.layers[gname][key]
            if isinstance(zv, tuple):  # a list once it has been in a file
                zv, gv = list(zv), list(gv)
            # The program applies an activation as an op of its own.
            same = (torch.equal(zv, gv) if isinstance(zv, torch.Tensor)
                    else key == "activation" or zv == gv)
            check(same, f"{zname}/{key} != {gname}/{key}")
    print(f"[artifact] program ({len(fixture['program']['ops'])} ops) -> "
          f"init + convert + save + load {time.perf_counter() - t0:.2f} s, "
          f"{os.path.getsize(path)} bytes", flush=True)
    xb = rng.normal(0, 1, (B, *interp.spec.input_size, 3)).astype(
        np.float32)
    reset()
    probs = interp(xb)
    torch.cuda.synchronize()
    launches["artifact"] = counts()
    check(launches["artifact"] == qn, f"artifact forward: {qn} launches "
          f"expected, got {launches['artifact']}")
    zprobs = zinterp(xb)
    check(tuple(probs.shape) == (B, 1000)
          and bool(torch.isfinite(probs).all()), "artifact forward's output")
    check(torch.equal(probs, zprobs), "the self-contained artifact's "
          "probabilities differ from the zoo model's on the same weights "
          f"(max |diff| {max_abs_diff(probs, zprobs)})")
    print("[artifact] Interpreter(artifact_path=) with no model: "
          f"{launches['artifact']} launches (expected {qn}), probabilities "
          f"equal to the zoo QuickNet's on the same weights ({TOLERANCE})",
          flush=True)
    del zinterp, zlayers

    # cli: the converter's command line, calibrating on the card.
    path8 = os.path.join(tmp, "quicknet_int8.npz")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "compute_engine_tpu_torch.converter.cli",
         "--model", "quicknet", "--output", path8, "--seed", "0",
         "--int8-calib-batches", "2", "--device", str(dev)], cwd=root, capture_output=True,
        text=True, timeout=600)
    check(cli.returncode == 0, f"the CLI exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    said = json.loads(cli.stdout.strip().splitlines()[-1])
    check(said == {"model": "quicknet", "output": path8, "layers": 39,
                   "binary_layers": 16, "packed_weight_bytes": 1566720,
                   "int8": True}, f"the CLI's JSON line: {said}")
    interp8 = Interpreter(artifact_path=path8, device=dev)
    reset()
    probs8 = interp8(xb)
    torch.cuda.synchronize()
    launches["cli_int8_artifact"] = counts()
    check(launches["cli_int8_artifact"] == (0, 16, 0), "int8 artifact "
          "forward: 16 bgemm launches and no block launch, got "
          f"{launches['cli_int8_artifact']}")
    check(tuple(probs8.shape) == (B, 1000)
          and bool(torch.isfinite(probs8).all()), "int8 artifact's output")
    print(f"[cli] converter.cli --int8-calib-batches 2 in a subprocess "
          f"{time.perf_counter() - t0:.2f} s: {json.dumps(said)}; its "
          f"artifact's forward: {launches['cli_int8_artifact'][1]} bgemm "
          "launches, 0 block launches", flush=True)

    # serve (full batches): 512 float32 requests, in order, one thread.
    images = rng.normal(0, 1, (4 * B, *interp.spec.input_size, 3)).astype(
        np.float32)
    reset()
    with ServingEngine(interp, batch_size=B, max_delay_ms=5000) as eng:
        served, _, _ = serve(eng, images)
    launches["serve_full"] = counts()
    stats = eng.stats
    check((stats.requests, stats.batches, stats.padded_slots) == (4 * B, 4, 0),
          f"full-batch serve: {stats}")
    check(launches["serve_full"] == times(4), f"full-batch serve: "
          f"{times(4)} launches expected, got {launches['serve_full']}")
    direct = np.concatenate([interp(images[i:i + B]).cpu().numpy()
                             for i in range(0, 4 * B, B)])
    served = np.stack(served)
    equal_rows = int((served == direct).all(-1).sum())
    print(f"[serve] full batches: {4 * B} requests in {stats.batches} batches, "
          f"{stats.padded_slots} padded slots, {launches['serve_full']} "
          f"launches (expected {times(4)}); rows equal to the direct "
          "forward's "
          f"({TOLERANCE}): {equal_rows}/{4 * B}, max |dprob| "
          f"{np.abs(served - direct).max():.3g}", flush=True)
    check(equal_rows == 4 * B, "a served row differs from the direct forward")

    # serve (ragged, concurrent): 8 threads, bursts, max_delay 5 ms.
    reset()
    n_r = 300 * B // 128
    with ServingEngine(interp, batch_size=B, max_delay_ms=5) as eng:
        ragged, lat_r, wall_r = serve(eng, images[:n_r], submitters=8,
                                      burst=(12, 0.03))
    launches["serve_ragged"] = counts()
    stats = eng.stats
    check(stats.requests == n_r and stats.requests + stats.padded_slots
          == B * stats.batches, f"ragged serve: {stats}")
    check(launches["serve_ragged"] == times(stats.batches),
          f"ragged serve: {qn} launches a batch, got "
          f"{launches['serve_ragged']} for {stats.batches} batches")
    padded = np.concatenate([images[:n_r],
                             np.zeros_like(images[:3 * B - n_r])])
    direct_r = np.concatenate([interp(padded[i:i + B]).cpu().numpy()
                               for i in range(0, 3 * B, B)])[:n_r]
    ragged = np.stack(ragged)
    agree = int((ragged.argmax(-1) == direct_r.argmax(-1)).sum())
    equal_rows = int((ragged == direct_r).all(-1).sum())
    print(f"[serve] ragged: {n_r} requests from 8 threads in {stats.batches} "
          f"batches, mean batch fill {stats.mean_batch_fill:.4f}, "
          f"{n_r / wall_r:.1f} requests/s, latency p50 "
          f"{percentile(lat_r, 50) * 1e3:.2f} ms p99 "
          f"{percentile(lat_r, 99) * 1e3:.2f} ms; top-1 agreement with the "
          f"direct forward in zero-padded batches {agree}/{n_r}, rows equal "
          f"bit for bit {equal_rows}/{n_r}, max |dprob| "
          f"{np.abs(ragged - direct_r).max():.3g} [{card}]", flush=True)
    check(agree == n_r, f"ragged serve: top-1 agreement {agree}/{n_r}")

    # An infer_fn that raises once fails that batch's requests and no other.
    class Flaky:
        device = interp.device
        failed = False

        def __call__(self, batch):
            if not self.failed:
                self.failed = True
                raise RuntimeError("injected failure")
            return interp(batch)

    with ServingEngine(Flaky(), batch_size=4, max_delay_ms=2000) as eng:
        first = [eng.submit(img) for img in images[:4]]
        errors = [f.exception(timeout=600) for f in first]
        later = [eng.submit(img) for img in images[:4]]
        answers = np.stack([f.result(timeout=600) for f in later])
    check(all(isinstance(e, RuntimeError) and "injected" in str(e)
              for e in errors), f"the failing batch's futures: {errors}")
    check((eng.stats.requests, eng.stats.batches) == (4, 1)
          and (answers.argmax(-1) == direct[:4].argmax(-1)).all(),
          "requests after a failed batch are not answered")
    # A uint8 engine refuses a float32 request.
    interp_u8 = Interpreter(artifact_path=path, input_scale=1 / 127.5,
                            input_zero_point=127, device=dev)
    images_u8 = rng.integers(0, 256, images.shape).astype(np.uint8)
    refused = False
    with ServingEngine(interp_u8, batch_size=B, max_delay_ms=5) as eng:
        got_u8 = eng.predict(images_u8[0], timeout=600)
        try:
            eng.submit(images[0])
        except TypeError:
            refused = True
    want_u8 = interp(((images_u8[:1].astype(np.float32) - 127.0)
                      * np.float32(1 / 127.5)))[0].cpu().numpy()
    check(refused, "the uint8 engine took a float32 request")
    check(got_u8.argmax() == want_u8.argmax(), "the uint8 request's answer")
    print("[serve] an infer_fn that raises once fails its batch's 4 futures "
          "and later requests are answered; the uint8 engine refuses a "
          "float32 request with TypeError", flush=True)

    # serve (int8 artifact): 256 requests through the CLI's artifact.
    reset()
    with ServingEngine(interp8, batch_size=B, max_delay_ms=5000) as eng:
        served8, _, _ = serve(eng, images[:2 * B])
    launches["serve_int8_artifact"] = counts()
    direct8 = np.concatenate([interp8(images[i:i + B]).cpu().numpy()
                              for i in (0, B)])
    check((eng.stats.requests, eng.stats.batches, eng.stats.padded_slots)
          == (2 * B, 2, 0) and launches["serve_int8_artifact"] == (0, 32, 0),
          f"int8 serve: {eng.stats}, {launches['serve_int8_artifact']}")
    check(np.array_equal(np.stack(served8), direct8),
          "int8 serve: a served row differs from the direct forward")
    print(f"[serve] int8 artifact: {2 * B} requests in 2 batches, "
          f"{launches['serve_int8_artifact'][1]} bgemm launches, rows equal "
          f"to the direct forward's ({TOLERANCE})", flush=True)

    # times: full batches and ragged, float32 and uint8 requests.
    def timed(name, interpreter, reqs, **how):
        full = not how
        with ServingEngine(interpreter, batch_size=B,
                           max_delay_ms=5000 if full else 5) as eng:
            serve(eng, reqs[:B])  # pins the buffer, warms the forward
            before = dataclasses.replace(eng.stats)
            _, lat, wall = serve(eng, reqs, **how)
        d = {f.name: getattr(eng.stats, f.name) - getattr(before, f.name)
             for f in dataclasses.fields(eng.stats)}
        fill = d["requests"] / (d["requests"] + d["padded_slots"])
        per = {k: d[k] / d["batches"]
               for k in ("stack_ms", "h2d_ms", "forward_ms", "d2h_ms")}
        print(f"[serve-time] {name}: {len(reqs)} requests, "
              f"{len(reqs) / wall:.1f} requests/s, latency p50 "
              f"{percentile(lat, 50) * 1e3:.2f} ms p99 "
              f"{percentile(lat, 99) * 1e3:.2f} ms, {d['batches']} batches, "
              f"mean batch fill {fill:.4f}; per batch: host stack "
              f"{per['stack_ms']:.3f} ms, host->device {per['h2d_ms']:.3f} "
              f"ms, forward {per['forward_ms']:.3f} ms, device->host "
              f"{per['d2h_ms']:.3f} ms; benchmark_model in this run "
              f"{bench_images_per_s:.1f} images/s [{card}]", flush=True)

    many = np.concatenate([images, images])
    many_u8 = np.concatenate([images_u8, images_u8])
    timed("full batches, float32 requests", interp, many)
    timed("full batches, uint8 requests", interp_u8, many_u8)
    timed("ragged (8 threads, bursts), float32 requests", interp, images,
          submitters=8, burst=(12, 0.03))
    timed("ragged (8 threads, bursts), uint8 requests", interp_u8, images_u8,
          submitters=8, burst=(12, 0.03))
    del many, many_u8

    # evaluate.
    res = evaluate(interp.predict, synthetic_batches(4, B))
    check(res["images"] == 4 * B and res["top5"] >= res["top1"],
          f"evaluate: {res}")
    print(f"[evaluate] 4 synthetic batches of {B} through "
          f"Interpreter.predict: {json.dumps(res)} [{card}]", flush=True)

    # detection: the card against the CPU, fast and regular NMS.
    drng = np.random.default_rng(6)
    n_anchors, n_classes = 1917, 20
    anchors = torch.from_numpy(np.stack(
        [drng.uniform(0.1, 0.9, n_anchors), drng.uniform(0.1, 0.9, n_anchors),
         drng.uniform(0.1, 0.4, n_anchors), drng.uniform(0.1, 0.4, n_anchors)],
        axis=-1).astype(np.float32))
    raw = torch.from_numpy(drng.normal(0, 1, (4, n_anchors, 4))
                           .astype(np.float32))
    scores = torch.from_numpy(drng.uniform(0, 1, (4, n_anchors, n_classes))
                              .astype(np.float32))
    for regular in (False, True):
        kw = dict(max_detections=10, iou_threshold=0.5, score_threshold=0.3,
                  use_regular_nms=regular)
        want = detection_postprocess(raw, scores, anchors, **kw)
        t0 = time.perf_counter()
        got = detection_postprocess(raw.to(dev), scores.to(dev),
                                    anchors.to(dev), **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(all(g.is_cuda for g in got), "detection ran off the card")
        got = [g.cpu() for g in got]
        check(torch.allclose(got[0], want[0], atol=1e-5, rtol=0)
              and torch.equal(got[1], want[1])
              and torch.allclose(got[2], want[2], atol=1e-6, rtol=0)
              and torch.equal(got[3], want[3]) and int(want[3].min()) > 0,
              f"detection_postprocess (regular NMS {regular}): card != CPU")
        print(f"[detection] 4 x {n_anchors} anchors x {n_classes} classes, "
              f"{'regular' if regular else 'fast'} NMS: the card equals the "
              f"CPU (boxes atol 1e-5, classes and counts equal), "
              f"{int(want[3].sum())} detections, first call {ms:.1f} ms",
              flush=True)

    # native: the host library against numpy.
    check(get_lib() is not None, "the native host library did not build "
          "(is g++ installed?)")

    def numpy_pack(bits):
        pad = -bits.shape[-1] % 32
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
        return np.packbits(bits, axis=-1, bitorder="little").view("<u4")

    xf = drng.normal(0, 1, (64, 56, 100)).astype(np.float32)
    xi = drng.integers(-128, 128, (64, 56, 100), dtype=np.int8)
    check(np.array_equal(native_bitpack(xf), numpy_pack(xf < 0))
          and np.array_equal(native_bitpack(xi, 3), numpy_pack(xi < 3)),
          "native_bitpack != numpy")
    print("[native] libce_host built with g++; native_bitpack equals numpy "
          "for float32 and for int8 with a zero point (64x56x100)",
          flush=True)
    return launches, path


def expected_launches(model, batch, domain="float", kernel="auto"):
    """(block, bgemm, split-K) launches of one forward of the zoo ``model``
    at ``batch`` under ``kernel`` ("auto": what the committed table
    chooses), summed over the table consultations of ``domain``
    (``binary_layer_modes``) by the runtime's own dispatch
    (``select.layer_lowering``, ``select.layer_launches``)."""
    from compute_engine_tpu_torch.kernels import select
    from compute_engine_tpu_torch.models import get_model
    from compute_engine_tpu_torch.models.shapes import binary_layer_modes

    counts = [0, 0, 0]
    for _, r, dom, out_kind in binary_layer_modes(get_model(model), batch):
        if dom == domain:
            low = select.layer_lowering(kernel, r, dom, out_kind)
            for i, n in enumerate(select.layer_launches(low, r)):
                counts[i] += n
    return tuple(counts)


def launch_counts():
    from compute_engine_tpu_torch.kernels.bgemm import bgemm
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    return (binary_residual_block.launches, bgemm.launches,
            bgemm.splitk_launches)


def reset_launches():
    from compute_engine_tpu_torch.kernels.bgemm import bgemm
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    binary_residual_block.launches = 0
    bgemm.launches = bgemm.splitk_launches = 0


def zero_pad_compare(zrng, dev, checked=False):
    """The zero-padded block kernel against its plain version, ``torch.equal``:
    Bi-RealNet's four shapes at ``ZERO_PAD_BATCHES``, bfloat16 and float32,
    with and without the add; RAGGED and ODD, and C != C_out without the
    add. ``checked`` runs the kernel's debug build. Returns the cases."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    cases = [((n, *hwc), dtype, None)
             for n in ZERO_PAD_BATCHES for hwc in BIREAL_BLOCKS
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(RAGGED, torch.bfloat16, None), (ODD, torch.float32, None),
              (ODD, torch.bfloat16, None), ((8, 14, 14, 256), torch.bfloat16,
                                            384), (RAGGED, torch.float32, 20)]
    done = 0
    for shape, dtype, c_out in cases:
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=0)
        for residual in ((False,) if c_out else (True, False)):
            x, pf, tr = block_case(zrng, shape, dev, dtype, False, c_out)
            delta = zero_padding_tap_delta(pf, p)
            with debug_checks() if checked else contextlib.nullcontext():
                got = binary_residual_block(x, pf, tr, p,
                                            has_residual=residual,
                                            tap_delta=delta)
                torch.cuda.synchronize()
            want = binary_residual_block_plain(x, pf, tr, p,
                                               has_residual=residual)
            err = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want),
                  f"zero-padded residual_block {shape} -> {c_out or shape[-1]}"
                  f" {dtype} add={residual}{' debug' if checked else ''}: "
                  f"kernel != plain (max |diff| {err})")
            done += 1
    # Without the table the wrapper computes it on the spot: the same bits.
    x, pf, tr = block_case(zrng, (8, 28, 28, 128), dev, torch.bfloat16, False)
    p = BConv2DParams(channels_in=128, padding=Padding.SAME, pad_value=0)
    check(torch.equal(binary_residual_block(x, pf, tr, p),
                      binary_residual_block_plain(x, pf, tr, p)),
          "zero-padded residual_block without tap_delta != plain")
    print(f"[compare] zero-padded residual_block{' (debug build)' * checked}:"
          f" {done} cases equal ({TOLERANCE}): Bi-RealNet's "
          f"{len(BIREAL_BLOCKS)} stride-1 shapes at batches "
          f"{ZERO_PAD_BATCHES} in bfloat16 and float32 with and without the "
          f"add, {RAGGED} and {ODD}, C != C_out", flush=True)
    return done


def zero_pad_phase(dev, card):
    """``--zero-pad-only``: the comparisons in both builds, QuickNet's
    one-padded blocks still equal, a debug check tripped on a zero-padded
    call, the times at Bi-RealNet's b128 shapes and Bi-RealNet-18 b128
    through ``Interpreter``."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.kernels import debug_checks, select
    from compute_engine_tpu_torch.kernels.bgemm import bgemm_plain
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model, packed_apply)
    from compute_engine_tpu_torch.runtime import Interpreter

    zrng = np.random.default_rng(17)
    zero_pad_compare(zrng, dev)
    zero_pad_compare(zrng, dev, checked=True)
    for shape in QUICKNET_BLOCKS:
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=1)
        x, pf, tr = block_case(zrng, shape, dev, torch.bfloat16, False)
        check(torch.equal(binary_residual_block(x, pf, tr, p),
                          binary_residual_block_plain(x, pf, tr, p)),
              f"one-padded residual_block {shape}: kernel != plain")
    print(f"[compare] one-padded residual_block at the QuickNet shapes: "
          f"equal ({TOLERANCE})", flush=True)
    ones, pf, tr = block_case(zrng, (4, 7, 7, 64), dev, torch.bfloat16, True)
    ones = torch.ones_like(ones)
    pf = torch.zeros_like(pf)
    p = BConv2DParams(channels_in=64, padding=Padding.SAME, pad_value=0)
    with debug_checks():
        trip = expect_trip(lambda: binary_residual_block(
            ones, pf, tr, p, _debug_k=9 * 64 - 32), "one-padding")
    print(f"[compare] zero-padded debug build tripped on purpose: {trip}",
          flush=True)

    # Times at batch 128, all by CUDA-graph replay: the zero-padded block
    # beside the one-padded one at the same shape (both with the add), and
    # the zero-padded lowerings it replaces, as the autotuner runs them.
    zero_ms = one_ms = 0.0
    rows = []
    for (h, w, c), count in zip(BIREAL_BLOCKS, BIREAL_BLOCK_COUNTS):
        shape = (128, h, w, c)
        x, pf, tr = block_case(zrng, shape, dev, torch.bfloat16, False)
        pz = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=0)
        p1 = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        delta = zero_padding_tap_delta(pf, pz)
        tz = time_ms(lambda: binary_residual_block(x, pf, tr, pz,
                                                   tap_delta=delta), reps=50)
        t1 = time_ms(lambda: binary_residual_block(x, pf, tr, p1), reps=50)
        rivals = select.autotune_bconv2d(
            [dict(h=h, w=w, c_in=c, c_out=c, fh=3, pad_value=0)], batch=128,
            update_table=False, candidates={"float/bgemm", "float/mxu"},
            device=dev)
        (per,) = rivals.values()
        rival = {k: v * 1e3 for (_, k), v in per.items()}
        zero_ms += count * tz
        one_ms += count * t1
        rows.append({"shape": list(shape), "zero_pad_ms": tz,
                     "one_pad_ms": t1, **{f"{k}_ms": v
                                          for k, v in rival.items()}})
        print(f"[zero-pad-time] {'x'.join(map(str, shape))} bf16 with the "
              f"add: zero-padded block {tz:.4f} ms, one-padded block "
              f"{t1:.4f} ms, " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in rival.items())
              + f" [{card}]", flush=True)
    quicknet_ms = sum(BLOCKS_PER_SHAPE * time_block(zrng, s, dev, False)["ms"]
                      for s in QUICKNET_BLOCKS)
    print(f"[zero-pad-time] Bi-RealNet-18's 13 stride-1 blocks per b128 "
          f"forward: zero-padded {zero_ms:.4f} ms, one-padded at the same "
          f"shapes {one_ms:.4f} ms; QuickNet's 16 one-padded blocks "
          f"{quicknet_ms:.4f} ms per forward [{card}]", flush=True)

    # Bi-RealNet-18 b128 through Interpreter: the launches the committed
    # table gives, logits equal to the forward through the plain versions.
    spec = get_model("birealnet18")
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    x = torch.from_numpy(zrng.normal(0, 1, (128, 224, 224, 3)).astype(
        np.float32)).to(dev)
    interp = Interpreter(spec, layers, output_mode="logits", device=dev)
    interp(x)
    reset_launches()
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block as block)
    block.zero_pad_launches = 0
    got = interp(x)
    launches = launch_counts()
    want_launches = expected_launches("birealnet18", 128)
    check(launches == want_launches, f"Bi-RealNet-18 b128 launches "
          f"{launches}, expected {want_launches}")
    check(block.zero_pad_launches == launches[0], "zero-padded launches "
          f"{block.zero_pad_launches} of {launches[0]} block launches")
    plain = packed_apply(spec, interp.layers, x, return_logits=True,
                         device=dev, residual_block=binary_residual_block_plain,
                         gemm=bgemm_plain)
    check(torch.equal(got, plain.to(got.dtype)),
          "Bi-RealNet-18 b128 logits != the plain versions' forward "
          f"(max |diff| {(got.float() - plain.float()).abs().max().item()})")
    print(f"[zero-pad] Bi-RealNet-18 b128 Interpreter: (block, bgemm, "
          f"split-K) launches {launches} as the table predicts, "
          f"{block.zero_pad_launches} zero-padded; logits equal to the plain "
          f"versions' forward ({TOLERANCE}) [{card}]", flush=True)
    return {"birealnet_blocks": rows, "birealnet_zero_pad_ms": zero_ms,
            "birealnet_one_pad_ms": one_ms, "quicknet_blocks_ms": quicknet_ms}


def dense_layers():
    """(height = width, C_in, the block's buffer width) of BinaryDenseNet-45's
    40 dense layers, in order."""
    for hw, c0, n in DENSE_BLOCKS:
        for i in range(n):
            yield hw, c0 + DENSE_GROWTH * i, c0 + DENSE_GROWTH * n


def dense_case(rng, batch, hw, c, width, dev, dtype):
    """A dense layer in place: a buffer of ``width`` channels with random
    values everywhere, the layer's filter and transform (C_in = ``c``, 64
    out); the layer reads ``buf[..., :c]`` and writes
    ``buf[..., c:c + 64]``."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(2 ** 62)))
    buf = torch.randn((batch, hw, hw, width), generator=g, device=dev).to(
        dtype)
    flat = buf.view(-1)
    flat[::97] = 0.0
    flat[1::89] = -0.0
    _, pf, tr = block_case(rng, (1, 1, 1, c), dev, dtype, False,
                           DENSE_GROWTH)
    return buf, pf, tr


def dense_compare(rng, dev, batch=8, checked=False):
    """The block kernel in place against its plain version, ``torch.equal``
    over the whole buffer (the slot written, every other channel as it
    was): BinaryDenseNet-45's 40 dense layers at ``batch`` in bfloat16, the
    first and last layer of each block in float32 too, and
    ``DENSE_B128``. ``checked`` runs the kernel's debug build. Returns the
    cases."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    cases = [(batch, hw, c, width, torch.bfloat16)
             for hw, c, width in dense_layers()]
    cases += [(batch, hw, c0 + DENSE_GROWTH * i, c0 + DENSE_GROWTH * n,
               torch.float32)
              for hw, c0, n in DENSE_BLOCKS for i in (0, n - 1)]
    cases.append((128, *DENSE_B128, torch.bfloat16))
    # One pixel (the last block of a 32x32 DenseNet-45 at batch 1), whose
    # channel slices PyTorch counts as dense.
    _, c0, n = DENSE_BLOCKS[-1]
    cases += [(1, 1, c0 + DENSE_GROWTH * i, c0 + DENSE_GROWTH * n,
               torch.bfloat16) for i in (0, n - 1)]
    for n, hw, c, width, dtype in cases:
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        buf, pf, tr = dense_case(rng, n, hw, c, width, dev, dtype)
        got, want = buf.clone(), buf.clone()
        slot = slice(c, c + DENSE_GROWTH)
        with debug_checks() if checked else contextlib.nullcontext():
            binary_residual_block(got[..., :c], pf, tr, p, has_residual=False,
                                  out=got[..., slot])
            torch.cuda.synchronize()
        binary_residual_block_plain(want[..., :c], pf, tr, p,
                                    has_residual=False, out=want[..., slot])
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want),
              f"residual_block in place {n}x{hw}x{hw} C_in {c} of {width} "
              f"{dtype}{' debug' if checked else ''}: kernel != plain "
              f"(max |diff| {err})")
    print(f"[compare] residual_block in place{' (debug build)' * checked}: "
          f"{len(cases)} cases equal ({TOLERANCE}): BinaryDenseNet-45's "
          f"40 dense layers at b{batch} reading a channel prefix and writing "
          f"their slot, bf16, float32 at each block's first and last, "
          f"{DENSE_B128} at b128 and the last block's first and last at "
          f"one pixel", flush=True)
    return len(cases)


def dense_layer_times(rng, dev, in_place=True):
    """Milliseconds of BinaryDenseNet-45's 40 dense layers at b128 in bf16,
    each by CUDA-graph replay: in place (the prefix of the block's buffer
    in, the slot out) or, with ``in_place=False``, on a dense input of its
    C_in channels into a new tensor, as before the stream lay in place."""
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block)

    total = 0.0
    for hw, c, width in dense_layers():
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        buf, pf, tr = dense_case(rng, 128, hw, c, width, dev, torch.bfloat16)
        if in_place:
            x, out = buf[..., :c], buf[..., c:c + DENSE_GROWTH]
            total += time_ms(lambda: binary_residual_block(
                x, pf, tr, p, has_residual=False, out=out), reps=20)
        else:
            x = buf[..., :c].contiguous()
            total += time_ms(lambda: binary_residual_block(
                x, pf, tr, p, has_residual=False), reps=20)
        del buf
    return total


def dense_phase(dev, card):
    """``--dense-only``: the in-place comparisons in both builds, QuickNet's
    and Bi-RealNet's contiguous blocks still equal, the 40 dense layers
    timed in place beside their contiguous form, and BinaryDenseNet-45 b128
    through ``Interpreter`` with its stream in place against the same
    forward concatenated by ``torch.cat``: logits equal, the launches and
    concatenations counted, both timed and profiled."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.models.builder import (PackedBuilder,
                                                         _Base, concat)
    from compute_engine_tpu_torch.runtime import Interpreter

    drng = np.random.default_rng(45)
    dense_compare(drng, dev)
    dense_compare(drng, dev, checked=True)
    for (h, w, c), zero in ([(s[1:], False) for s in QUICKNET_BLOCKS]
                            + [(s, True) for s in BIREAL_BLOCKS]):
        p = BConv2DParams(channels_in=c, padding=Padding.SAME,
                          pad_value=0 if zero else 1)
        x, pf, tr = block_case(drng, (128, h, w, c), dev, torch.bfloat16,
                               False)
        delta = zero_padding_tap_delta(pf, p) if zero else None
        check(torch.equal(binary_residual_block(x, pf, tr, p,
                                                tap_delta=delta),
                          binary_residual_block_plain(x, pf, tr, p)),
              f"{'zero' if zero else 'one'}-padded residual_block "
              f"128x{h}x{w}x{c}: kernel != plain")
    print(f"[compare] contiguous residual_block with the add at QuickNet's "
          f"and Bi-RealNet's b128 shapes: equal ({TOLERANCE})", flush=True)

    dense_ms = {"in_place": dense_layer_times(drng, dev),
                "contiguous": dense_layer_times(drng, dev, in_place=False)}
    print(f"[dense-time] BinaryDenseNet-45's 40 dense layers a b128 forward "
          f"(bf16, graph replays): in place {dense_ms['in_place']:.4f} ms, "
          f"contiguous {dense_ms['contiguous']:.4f} ms [{card}]", flush=True)

    spec = get_model("binary_densenet45")
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    x = torch.from_numpy(drng.normal(0, 1, (128, 224, 224, 3)).astype(
        np.float32)).to(dev)
    runs, in_place_block = {}, PackedBuilder.dense_block
    for label in ("in_place", "torch.cat"):
        if label == "torch.cat":
            PackedBuilder.dense_block = _Base.dense_block
        try:
            interp = Interpreter(spec, layers, output_mode="logits",
                                 device=dev)
            interp(x)  # compiles
            reset_launches()
            concat.launches = concat.in_place = 0
            logits = interp(x).clone()
            got = (*launch_counts(), concat.launches, concat.in_place)
            ms = time_ms(lambda: interp(x), reps=20, graph=False)
            print(f"[dense] BinaryDenseNet-45 b128 Interpreter, {label}: "
                  f"(block, bgemm, split-K, concatenations, in place) "
                  f"{got}; {ms:.4f} ms a forward by CUDA events over 20 "
                  f"calls [{card}]", flush=True)
            busy = profile_forward(lambda: interp(x), top=30)
            runs[label] = {"launches": got, "ms": ms, "busy_ms": busy,
                           "logits": logits}
        finally:
            PackedBuilder.dense_block = in_place_block
        del interp
    check(runs["in_place"]["launches"] == (40, 0, 0, 40, 40),
          f"in place: launches {runs['in_place']['launches']}, expected 40 "
          f"block launches and 40 concatenations, all in place")
    check(runs["torch.cat"]["launches"] == (40, 0, 0, 40, 0),
          f"torch.cat: launches {runs['torch.cat']['launches']}")
    a, b = runs["in_place"]["logits"], runs["torch.cat"]["logits"]
    check(torch.equal(a, b), "BinaryDenseNet-45 b128 logits in place != "
          f"by torch.cat (max |diff| {(a - b).abs().max().item()})")
    print(f"[dense] logits in place equal to those by torch.cat "
          f"({TOLERANCE})", flush=True)
    return {"dense_layers_ms": dense_ms,
            **{f"forward_ms.{k}": v["ms"] for k, v in runs.items()},
            **{f"busy_ms.{k}": v["busy_ms"] for k, v in runs.items()}}


def stem_case(rng, batch, dev, dtype="float32"):
    """Inputs of the stem: ``batch`` images of ``STEM_IMAGE`` in ``dtype``
    (with exact +0.0 and -0.0 entries), a folded kernel and a bias."""
    import numpy as np
    import torch

    x = rng.normal(0, 1, (batch, *STEM_IMAGE)).astype(np.float32)
    x.reshape(-1)[::97] = 0.0
    x.reshape(-1)[1::89] = -0.0
    kernel = rng.normal(0, 0.15, STEM_KERNEL).astype(np.float32)
    bias = rng.normal(0, 1, STEM_KERNEL[-1]).astype(np.float32)
    return (torch.from_numpy(x).to(dev).to(getattr(torch, dtype)),
            torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev))


def stem_compare(rng, dev, checked=False):
    """The stem kernel against its plain version (cuDNN's conv and
    PyTorch's pool) and against its float64 sums (``stem_conv_pool_exact``),
    at ``STEM_BATCHES`` for
    float32 and bfloat16 images: every output within one bf16 ulp, or
    beyond it only by what reordering a float32 sum moves it
    (``stem.within_tolerance``). ``checked`` runs the debug build. Returns
    the cases and the largest gap in ulps."""
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.stem import (
        stem_conv_pool, stem_conv_pool_exact, stem_conv_pool_plain,
        stem_filter, within_tolerance)

    worst, cases = 0.0, 0
    for batch in STEM_BATCHES:
        for dtype in ("float32", "bfloat16"):
            x, kernel, bias = stem_case(rng, batch, dev, dtype)
            with debug_checks() if checked else contextlib.nullcontext():
                got = stem_conv_pool(x, kernel, bias,
                                     filter_bf16=stem_filter(kernel))
                torch.cuda.synchronize()
            for label, want in (("plain", stem_conv_pool_plain(x, kernel,
                                                               bias)),
                                ("float64", stem_conv_pool_exact(
                                    x, kernel, bias))):
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"stem b{batch} {dtype}: {tuple(got.shape)} "
                      f"{got.dtype} against {tuple(want.shape)}")
                ok, ulps = within_tolerance(got, want, x, kernel, bias)
                over = int((ulps > 1).sum())
                check(bool(ok.all()), f"stem b{batch} {dtype} against the "
                      f"{label} version{' (debug)' * checked}: "
                      f"{int((~ok).sum())} outputs beyond the tolerance, "
                      f"{ulps.max().item():.3g} ulps at most")
                worst = max(worst, float(ulps.max()))
                print(f"[compare] stem b{batch} {dtype} images"
                      f"{' (debug build)' * checked} against the {label} "
                      f"version: within tolerance; {int((ulps == 0).sum())}"
                      f" of {ulps.numel()} equal, {over} beyond one ulp, "
                      f"{ulps.max().item():.3g} ulps at most", flush=True)
                cases += 1
            del x, got
    return cases, worst


def stem_times(rng, dev, card, yardsticks=True):
    """Milliseconds of the stem at b128 on float32 images, by CUDA-graph
    replay: the kernel (with the filter prepared once, as the runtime does),
    and with ``yardsticks`` its plain chain and ``library_ms``, cuDNN's
    bf16 conv with its bias on the padded bf16 images then PyTorch's max
    pool (no call of the port); and the bound."""
    import torch

    from compute_engine_tpu_torch.models import layers as L

    x, kernel, bias = stem_case(rng, 128, dev)
    n, h, w, c = x.shape
    nbytes = x.numel() * 4 + n * (h // 4) * (w // 4) * 64 * 2
    flops = 2 * n * (h // 2) * (w // 2) * 64 * 7 * 7 * c
    times = {"ms": None, "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                                         flops / 989e12) * 1e3}
    try:
        from compute_engine_tpu_torch.kernels.stem import (stem_conv_pool,
                                                           stem_filter)
    except ImportError:  # a checkout before the kernel: its chain alone
        stem_conv_pool = None
    if stem_conv_pool is not None:
        filt = stem_filter(kernel)
        times["ms"] = time_ms(lambda: stem_conv_pool(
            x, kernel, bias, filter_bf16=filt), reps=50)
    if yardsticks:
        # The packed builder's chain, as the plain version runs it, with the
        # TF32 conv of PyTorch's default flags, as the benchmark's cells run.
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=True):
            times["plain_ms"] = time_ms(lambda: L.max_pool(
                (L.conv2d(x.to(torch.bfloat16), kernel, (2, 2), "SAME")
                 + bias).to(torch.bfloat16), (3, 3), (2, 2), "SAME"), reps=10)
        xp = torch.nn.functional.pad(
            x.to(torch.bfloat16).permute(0, 3, 1, 2), (2, 3, 2, 3))
        wb = kernel.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        times["library_ms"] = time_ms(
            lambda: torch.nn.functional.max_pool2d(
                torch.nn.functional.conv2d(xp, wb, bb, stride=2), 3, 2,
                padding=1), reps=50)
    print(f"[stem-time] stem b128 float32 images: kernel "
          f"{ms_text(times['ms'])}, bound {times['bound_ms']:.4f} ms (bytes)"
          + (f", plain (TF32 conv) {times['plain_ms']:.4f} ms, library "
             f"(cuDNN bf16 conv"
             f" + max pool) {times['library_ms']:.4f} ms" if yardsticks
             else "") + f" [{card}]", flush=True)
    return times


def stem_phase(dev, card):
    """``--stem-only``: the stem kernel against its plain version and the
    exact conv in the default and the debug build, its debug check passed
    and tripped, its times at b128, and Bi-RealNet-18, BinaryDenseNet-45
    and QuickNet at b128 through ``Interpreter``: the stem launches a
    forward (``STEM_LAUNCHES``), and each forward beside the same forward
    with the stem's plain version (logits' gap, ms a forward)."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels import stem as stem_mod
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.runtime import Interpreter

    srng = np.random.default_rng(23)
    cases, worst = stem_compare(srng, dev)
    dcases, dworst = stem_compare(srng, dev, checked=True)
    x, kernel, bias = stem_case(srng, 2, dev)
    farthest = stem_mod.farthest_read(
        stem_mod.plan_stem(*x.shape, *STEM_KERNEL[:2]), *STEM_KERNEL[:3])
    with debug_checks():
        stem_mod.stem_conv_pool(x, kernel, bias,
                                _debug_patch_elems=farthest + 1)
        torch.cuda.synchronize()
        trip = expect_trip(lambda: stem_mod.stem_conv_pool(
            x, kernel, bias, _debug_patch_elems=farthest), "stem")
    print(f"[compare] stem debug build: silent at a patch of {farthest + 1} "
          f"elements, tripped on purpose at {farthest}: {trip}", flush=True)
    times = stem_times(srng, dev, card)

    forwards = {}
    kernel_fn = stem_mod.stem_conv_pool
    for model, want in STEM_LAUNCHES.items():
        spec = get_model(model)
        layers = convert_model(spec, init_model(spec, seed=0,
                                                randomize_bn=True))
        xm = torch.from_numpy(srng.normal(0, 1, (128, 224, 224, 3)).astype(
            np.float32)).to(dev)
        runs = {}
        for label in ("kernel", "plain"):
            if label == "plain":
                stem_mod.stem_conv_pool = (
                    lambda *a, filter_bf16=None, **kw:
                    stem_mod.stem_conv_pool_plain(*a, **kw))
            try:
                interp = Interpreter(spec, layers, output_mode="logits",
                                     device=dev)
                interp(xm)  # compiles
                kernel_fn.launches = 0
                logits = interp(xm).clone()
                launches = kernel_fn.launches
                ms = time_ms(lambda: interp(xm), reps=20, graph=False)
                runs[label] = (logits, launches, ms)
                del interp
            finally:
                stem_mod.stem_conv_pool = kernel_fn
        (a, launches, ms), (b, plain_launches, plain_ms) = (runs["kernel"],
                                                            runs["plain"])
        check(launches == want and plain_launches == 0,
              f"{model} b128: {launches} stem launches a forward, expected "
              f"{want} ({plain_launches} with the plain version)")
        agree = int((a.argmax(-1) == b.argmax(-1)).sum())
        gap = (a - b).abs().max().item()
        print(f"[stem] {model} b128 Interpreter: {launches} stem launch(es) "
              f"a forward; {ms:.4f} ms a forward against {plain_ms:.4f} ms "
              f"with the stem's plain version (CUDA events, 20 calls); "
              f"logits max |diff| {gap:.3g}, top-1 agreement {agree}/128 "
              f"[{card}]", flush=True)
        forwards[model] = {"launches": launches, "ms": ms,
                           "plain_ms": plain_ms, "max_logit_gap": gap,
                           "top1_agree": agree}
    return {"compare_cases": cases + dcases,
            "worst_ulps": max(worst, dworst), "times": times,
            "forwards": forwards}


def transition_case(gen, batch, shape, dev, prefix=0):
    """Inputs of one of DenseNet-45's transitions, drawn on the card from
    ``gen``: a bf16 stream of ``batch`` images of ``shape`` (with exact
    +0.0 and -0.0 entries), the channel prefix of a buffer ``prefix``
    channels wider where ``prefix`` is given; a folded 1x1 kernel and a
    bias."""
    import torch

    hw, c, c_out = shape
    buf = torch.randn((batch, hw, hw, c + prefix), generator=gen,
                      device=dev).to(torch.bfloat16)
    flat = buf.view(-1)
    flat[::97] = 0.0
    flat[1::89] = -0.0
    kernel = torch.randn((1, 1, c, c_out), generator=gen, device=dev) * (
        2.0 / c) ** 0.5
    bias = torch.randn((c_out,), generator=gen, device=dev) * 0.5
    return buf[..., :c], kernel, bias


def transition_compare(dev, checked=False):
    """The transition kernel against its plain version (cuDNN's conv,
    PyTorch's pool) and against its float64 sums
    (``transition_conv_pool_exact``) at DenseNet-45's three transitions, at
    ``TRANSITION_BATCHES`` on a dense stream and at batch 3 on a channel
    prefix of a wider buffer: every output within one bf16 ulp, or beyond
    it only by what reordering a float32 sum moves it
    (``transition.within_tolerance``). ``checked`` runs the debug build.
    Returns the cases and the largest gap in ulps."""
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.transition import (
        transition_conv_pool, transition_conv_pool_exact,
        transition_conv_pool_plain, transition_filter, within_tolerance)

    gen = torch.Generator(device=dev)
    gen.manual_seed(25 + checked)
    worst, cases = 0.0, 0
    runs = [(b, shape, 0) for b in TRANSITION_BATCHES for shape in TRANSITIONS]
    runs += [(3, shape, TRANSITION_PREFIX) for shape in TRANSITIONS]
    for batch, shape, prefix in runs:
        x, kernel, bias = transition_case(gen, batch, shape, dev, prefix)
        with debug_checks() if checked else contextlib.nullcontext():
            got = transition_conv_pool(x, kernel, bias,
                                       filter_bf16=transition_filter(kernel))
            torch.cuda.synchronize()
        label = (f"transition b{batch} {shape[0]}x{shape[0]}x{shape[1]} -> "
                 f"{shape[2]}" + (f" (prefix of {shape[1] + prefix})"
                                  if prefix else "")
                 + " (debug build)" * checked)
        for name, want in (("plain", transition_conv_pool_plain(x, kernel,
                                                                bias)),
                           ("float64", transition_conv_pool_exact(
                               x, kernel, bias))):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{label}: {tuple(got.shape)} {got.dtype} against "
                  f"{tuple(want.shape)}")
            ok, ulps = within_tolerance(got, want, x, kernel, bias)
            check(bool(ok.all()), f"{label} against the {name} version: "
                  f"{int((~ok).sum())} outputs beyond the tolerance, "
                  f"{ulps.max().item():.3g} ulps at most")
            worst = max(worst, float(ulps.max()))
            print(f"[compare] {label} against the {name} version: within "
                  f"tolerance; {int((ulps == 0).sum())} of {ulps.numel()} "
                  f"equal, {int((ulps > 1).sum())} beyond one ulp, "
                  f"{ulps.max().item():.3g} ulps at most", flush=True)
            cases += 1
        del x, got, want
    return cases, worst


def transition_times(dev, card, yardsticks=True):
    """Milliseconds of DenseNet-45's three transitions a b128 forward, by
    CUDA-graph replay: the kernel (with the filters prepared once, as the
    runtime does), and with ``yardsticks`` its plain chain (the TF32 conv
    of the cells' float32 flags) and ``library_ms``, cuDNN's bf16 1x1 conv
    with its bias on the channels-last stream then PyTorch's average pool
    (no call of the port); and the bound (the stream read once, the pooled
    stream written once, the bf16 filters and float32 biases once, at
    3.35 TB/s). A checkout without the kernel times its chain alone."""
    import torch

    from compute_engine_tpu_torch.models import layers as L

    try:
        from compute_engine_tpu_torch.kernels.transition import (
            transition_conv_pool, transition_filter)
    except ImportError:
        transition_conv_pool = None
    gen = torch.Generator(device=dev)
    gen.manual_seed(2525)
    times = {"ms": 0.0 if transition_conv_pool else None, "plain_ms": 0.0,
             "library_ms": 0.0, "bound_ms": 0.0}
    for shape in TRANSITIONS:
        x, kernel, bias = transition_case(gen, 128, shape, dev)
        hw, c, c_out = shape
        nbytes = (x.numel() * 2 + 128 * (hw // 2) ** 2 * c_out * 2
                  + c * c_out * 2 + c_out * 4)
        times["bound_ms"] += nbytes / PEAK_BYTES_PER_S * 1e3
        row = {}
        if transition_conv_pool is not None:
            filt = transition_filter(kernel)
            row["ms"] = time_ms(lambda: transition_conv_pool(
                x, kernel, bias, filter_bf16=filt), reps=50)
        if yardsticks:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=True):
                row["plain_ms"] = time_ms(lambda: L.avg_pool(
                    (L.conv2d(x, kernel, (1, 1), "SAME") + bias).to(
                        torch.bfloat16), (2, 2), (2, 2), "VALID"), reps=10)
            xn = x.permute(0, 3, 1, 2)
            wb = kernel.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bb = bias.to(torch.bfloat16)
            row["library_ms"] = time_ms(
                lambda: torch.nn.functional.avg_pool2d(
                    torch.nn.functional.conv2d(xn, wb, bb), 2, 2), reps=20)
        for k, v in row.items():
            times[k] += v
        print(f"[transition-time] b128 {hw}x{hw}x{c} -> {c_out}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
              + f", bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms [{card}]",
              flush=True)
        del x
    print(f"[transition-time] DenseNet-45's three transitions a b128 "
          f"forward: kernel {ms_text(times['ms'])}, bound "
          f"{times['bound_ms']:.4f} ms (bytes)"
          + (f", plain chain (TF32 conv) {times['plain_ms']:.4f} ms, library "
             f"(cuDNN bf16 1x1 conv + avg_pool2d) {times['library_ms']:.4f} ms"
             if yardsticks else "") + f" [{card}]", flush=True)
    return times


def transition_phase(dev, card):
    """``--transition-only``: the transition kernel against its plain
    version and the exact conv in the default and the debug build, its
    debug check passed and tripped, DenseNet-45's three transitions timed
    at b128, and DenseNet-45, QuickNet, Bi-RealNet-18 and MeliusNet-22 at
    b128 through ``Interpreter``: the transition launches a forward
    (``TRANSITION_LAUNCHES``), and DenseNet-45's forward beside the same
    forward with the transition's plain version (logits' gap, ms a
    forward, its profile)."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels import transition as tr
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model)
    from compute_engine_tpu_torch.runtime import Interpreter

    cases, worst = transition_compare(dev)
    dcases, dworst = transition_compare(dev, checked=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2526)
    x, kernel, bias = transition_case(gen, 2, TRANSITIONS[0], dev)
    farthest = tr.farthest_read(tr.plan_transition(*x.shape,
                                                   kernel.shape[3]))
    with debug_checks():
        tr.transition_conv_pool(x, kernel, bias,
                                _debug_tile_elems=farthest + 1)
        torch.cuda.synchronize()
        trip = expect_trip(lambda: tr.transition_conv_pool(
            x, kernel, bias, _debug_tile_elems=farthest), "transition")
    print(f"[compare] transition debug build: silent at a tile of "
          f"{farthest + 1} elements, tripped on purpose at {farthest}: "
          f"{trip}", flush=True)
    times = transition_times(dev, card)

    forwards = {}
    kernel_fn = tr.transition_conv_pool
    srng = np.random.default_rng(25)
    for model, want in TRANSITION_LAUNCHES.items():
        spec = get_model(model)
        layers = convert_model(spec, init_model(spec, seed=0,
                                                randomize_bn=True))
        xm = torch.from_numpy(srng.normal(0, 1, (128, 224, 224, 3)).astype(
            np.float32)).to(dev)
        runs = {}
        for label in ("kernel", "plain") if want else ("kernel",):
            if label == "plain":
                tr.transition_conv_pool = (
                    lambda *a, filter_bf16=None, **kw:
                    tr.transition_conv_pool_plain(*a, **kw))
            try:
                interp = Interpreter(spec, layers, output_mode="logits",
                                     device=dev)
                interp(xm)  # compiles
                kernel_fn.launches = 0
                logits = interp(xm).clone()
                launches = kernel_fn.launches
                ms = time_ms(lambda: interp(xm), reps=20, graph=False)
                busy = (profile_forward(lambda: interp(xm))
                        if want and label == "kernel" else None)
                runs[label] = (logits, launches, ms, busy)
                del interp
            finally:
                tr.transition_conv_pool = kernel_fn
        logits, launches, ms, busy = runs["kernel"]
        check(launches == want, f"{model} b128: {launches} transition "
              f"launches a forward, expected {want}")
        forwards[model] = {"launches": launches, "ms": ms, "busy_ms": busy}
        line = (f"[transition] {model} b128 Interpreter: {launches} "
                f"transition launch(es) a forward; {ms:.4f} ms a forward")
        if want:
            plain, plain_launches, plain_ms, _ = runs["plain"]
            check(plain_launches == 0, f"{model}: {plain_launches} launches "
                  "with the plain version")
            agree = int((logits.argmax(-1) == plain.argmax(-1)).sum())
            gap = (logits - plain).abs().max().item()
            line += (f" against {plain_ms:.4f} ms with the transition's "
                     f"plain version (CUDA events, 20 calls); logits max "
                     f"|diff| {gap:.3g}, top-1 agreement {agree}/128")
            forwards[model].update(plain_ms=plain_ms, max_logit_gap=gap,
                                   top1_agree=agree)
        print(line + f" [{card}]", flush=True)
    return {"compare_cases": cases + dcases,
            "worst_ulps": max(worst, dworst), "times": times,
            "forwards": forwards}


def react_blocks():
    """``(h, w, c, c_out, stride)`` of ReActNet-A's 13 blocks, as the
    benchmark's counts (``portbench/counts/reactnet_a.py``) read them from
    the configuration."""
    from portbench import spec

    cfg = spec.config("reactnet_a")
    return spec.module("counts", cfg["counts"])._blocks(cfg)


def react_stride1_shapes():
    """``(h, w, c)`` of ReActNet-A's stride-1 3x3 convs, each once."""
    shapes = []
    for h, w, c, _, stride in react_blocks():
        if stride == 1 and (h, w, c) not in shapes:
            shapes.append((h, w, c))
    return shapes


def react_pointwise_gemms(batch=128):
    """``(label, m, kw, n)`` of ReActNet-A's 13 1x1 convs at ``batch`` as
    the binary GEMM runs them: the block's output pixels as rows, its
    input's channels in words, its output's channels (a doubling pair one
    GEMM of 2C)."""
    gemms = []
    for i, (h, w, c, c_out, stride) in enumerate(react_blocks()):
        m = batch * -(-h // stride) * -(-w // stride)
        pair = " pair" if c_out == 2 * c else ""
        gemms.append((f"ReActNet-A b{batch} block {i}{pair} 1x1", m, c // 32,
                      c_out))
    return gemms


def react_case(batch, h, w, c, device, seed=0):
    """A (batch, h, w, c) bf16 input and a zero-padded 3x3 conv of it with
    its threshold and RPReLU: (x, packed filter, transform, params,
    tap_delta, +-1 filter, threshold, (shift_in, slope, shift_out))."""
    import torch

    from compute_engine_tpu_torch.core.bitpack import bitpack, bitunpack
    from compute_engine_tpu_torch.core.params import BConv2DParams
    from compute_engine_tpu_torch.core.reference import (
        zero_padding_tap_delta)
    from compute_engine_tpu_torch.core.transforms import (
        OutputTransform, fuse_output_transform)
    from compute_engine_tpu_torch.core.types import Padding

    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(batch, h, w, c, generator=g) * 2).to(device,
                                                          torch.bfloat16)
    pf = bitpack(torch.where(torch.rand(c, 3, 3, c, generator=g) < 0.5,
                             -1.0, 1.0)).to(device)
    post_mul = (torch.rand(c, generator=g) * 1.9 + 0.1).numpy()
    post_bias = ((torch.rand(c, generator=g) - 0.5) * 10).numpy()
    t = fuse_output_transform(post_mul, post_bias, 9 * c)
    tr = OutputTransform(clamp_min=t.clamp_min, clamp_max=t.clamp_max,
                         multiplier=torch.as_tensor(t.multiplier).to(device),
                         bias=torch.as_tensor(t.bias).to(device))
    params = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=0)
    threshold = (torch.randn(c, generator=g) * 0.3).to(device)
    rprelu = ((torch.randn(c, generator=g) * 0.3).to(device),
              (0.05 + 0.45 * torch.rand(c, generator=g)).to(device),
              (torch.randn(c, generator=g) * 0.3).to(device))
    return (x, pf, tr, params, zero_padding_tap_delta(pf, params),
            bitunpack(pf, c, dtype=torch.int8).permute(1, 2, 3, 0),
            threshold, rprelu)


def react_compare(dev):
    """The block kernel's ReActNet form ``torch.equal`` to its plain version
    at ReActNet-A's stride-1 3x3 shapes, b1/b8/b128, in the default and the
    debug build; returns the number of cases."""
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)

    shapes = react_stride1_shapes()
    cases = 0
    for checked in (False, True):
        for batch in (1, 8, 128):
            for i, (h, w, c) in enumerate(shapes):
                x, pf, tr, params, delta, pm1, thr, rp = react_case(
                    batch, h, w, c, dev, seed=i)
                with debug_checks() if checked else contextlib.nullcontext():
                    got = binary_residual_block(x, pf, tr, params,
                                                tap_delta=delta,
                                                threshold=thr, rprelu=rp)
                want = binary_residual_block_plain(
                    x, pf, tr, params, unpacked_filter=pm1, threshold=thr,
                    rprelu=rp)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"ReActNet form b{batch} {h}x{w}x{c} debug={checked}: "
                      f"kernel != plain (max |diff| "
                      f"{(got.float() - want.float()).abs().max().item()})")
                cases += 1
    print(f"[compare] ReActNet form: {cases} cases equal to the plain "
          f"version ({len(shapes)} shapes, b1/b8/b128, both builds)",
          flush=True)
    return cases


def reactnet_phase(dev, card):
    """``--reactnet-only``: the block kernel's ReActNet form against its
    plain version at ReActNet-A's stride-1 shapes (b1, b8, b128, both
    builds), the 9 blocks of a b128 forward timed in that form, without
    its threshold and RPReLU, and as the unfused chain, and ReActNet-A b128
    through ``Interpreter``: launches, thresholded launches and RPReLUs a
    forward, the logits against the same forward with every RPReLU
    unfused, both timed, the fused one profiled."""
    import torch

    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, rprelu_plain)
    from compute_engine_tpu_torch.models import (PackedBuilder,
                                                 convert_model, get_model)
    from compute_engine_tpu_torch.models.builder import (RPRELU_KEYS,
                                                         _float_view, rprelu)
    from compute_engine_tpu_torch.runtime import Interpreter

    from portbench import images, spec, system

    cases = react_compare(dev)

    # The 9 stride-1 blocks of a b128 forward, by CUDA-graph replay.
    cfg = spec.config("reactnet_a")
    counts = spec.module("counts", cfg["counts"])
    blocks = [(h, w, c) for h, w, c, _, stride in react_blocks()
              if stride == 1]
    forms = {"react": 0.0, "plain_form": 0.0, "unfused": 0.0}
    for i, (h, w, c) in enumerate(blocks):
        x, pf, tr, params, delta, _, thr, rp = react_case(128, h, w, c, dev,
                                                          seed=i)

        def unfused():
            y = binary_residual_block(x.float() + thr, pf, tr, params,
                                      has_residual=False, tap_delta=delta)
            return rprelu_plain(x + y.to(x.dtype), *rp)

        forms["react"] += time_ms(lambda: binary_residual_block(
            x, pf, tr, params, tap_delta=delta, threshold=thr, rprelu=rp),
            reps=20)
        forms["plain_form"] += time_ms(lambda: binary_residual_block(
            x, pf, tr, params, tap_delta=delta), reps=20)
        forms["unfused"] += time_ms(unfused, reps=20)
    _, floor_s = counts.residual_blocks(cfg, 128)
    print(f"[react-time] ReActNet-A's 9 stride-1 blocks a b128 forward: "
          f"ReActNet form {forms['react']:.4f} ms, the same blocks without "
          f"threshold and RPReLU {forms['plain_form']:.4f} ms, the unfused "
          f"chain (shifted input, conv, add, RPReLU) {forms['unfused']:.4f} "
          f"ms, floor {floor_s * 1e3:.4f} ms (bytes) [{card}]", flush=True)

    # ReActNet-A b128 through Interpreter, fused and with every RPReLU
    # unfused.
    model = get_model("reactnet_a")
    ref = spec.module("reference", cfg["reference"])
    seed = 2147626201
    params = ref.make_params(cfg, system.derive(seed, "weights"), dev)
    layers = convert_model(model, params)
    x = images.float_images(128, 224, 224, 3,
                            system.generator(seed, "inputs", dev), dev)
    fused_rprelu = PackedBuilder.rprelu
    runs = {}
    for label in ("fused", "unfused"):
        if label == "unfused":
            PackedBuilder.rprelu = lambda self, z, name: rprelu(
                _float_view(z),
                *(self.layers[name][f"rprelu_{k}"] for k in RPRELU_KEYS))
        try:
            interp = Interpreter(model, layers, output_mode="logits",
                                 device=dev)
            interp(x)  # compiles
            before = (binary_residual_block.launches,
                      binary_residual_block.threshold_launches,
                      rprelu.launches, rprelu.fused)
            logits = interp(x).clone()
            after = (binary_residual_block.launches,
                     binary_residual_block.threshold_launches,
                     rprelu.launches, rprelu.fused)
            ms = time_ms(lambda: interp(x), reps=20, graph=False)
            busy = (profile_forward(lambda: interp(x), top=16)
                    if label == "fused" else None)
            runs[label] = dict(
                logits=logits, ms=ms, busy_ms=busy,
                **dict(zip(("block", "threshold", "rprelu", "fused"),
                           (a - b for a, b in zip(after, before)))))
            del interp
        finally:
            PackedBuilder.rprelu = fused_rprelu
        r = runs[label]
        print(f"[reactnet] b128 Interpreter, RPReLU {label}: {r['block']} "
              f"block launch(es), {r['threshold']} thresholded, "
              f"{r['rprelu']} RPReLUs of which {r['fused']} fused; "
              f"{ms:.4f} ms a forward (20 calls) [{card}]", flush=True)
    check((runs["fused"]["block"], runs["fused"]["threshold"],
           runs["fused"]["rprelu"], runs["fused"]["fused"]) == (9, 9, 26, 9),
          f"ReActNet-A b128: launches {runs['fused']}")
    check(runs["unfused"]["threshold"] == 0 and runs["unfused"]["fused"] == 0,
          "the unfused forward ran the ReActNet form")
    same = torch.equal(runs["fused"]["logits"], runs["unfused"]["logits"])
    check(same, "ReActNet-A b128: fused and unfused logits differ")
    print(f"[reactnet] logits of the fused and the unfused forward "
          f"torch.equal: {same}", flush=True)
    return {"compare_cases": cases, "block_ms": forms,
            "floor_ms": floor_s * 1e3,
            "forwards": {k: {kk: vv for kk, vv in v.items()
                             if kk != "logits"} for k, v in runs.items()}}


def selection_phase(dev, card):
    """Phase 6(a): the planner's cells for QuickNet and BinaryAlexNet at
    batch 128, one per shape and table consultation, measured against an
    empty table: every candidate lowering passes the exactness gate against
    the GEMM's output and is timed; the winner is printed beside the
    committed table's choice (not gated: timings are noisy). The process
    table is left as it was."""
    from compute_engine_tpu_torch.kernels import autotune, select

    for cell in autotune.plan(("quicknet", "binary_alexnet"), (128,),
                              table={}, buckets=False):
        _, r, _, dom, out_kind = cell
        ms = autotune.measure(cell, device=dev, update_table=False)
        ms = {k.split("/")[1]: v for k, v in ms.items()}
        winner = min(ms, key=ms.get)
        committed = select.select_bconv2d_kernel(
            dom, out_kind=out_kind, **select.layer_kwargs(r))
        print(f"[select] {autotune.cell_label(cell)}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; winner {winner}, committed table {committed}; "
              f"every candidate equal to the GEMM's output [{card}]",
              flush=True)


def kernel_phase(dev, card, spec, layers, x, x_dev, plain_probs, alex,
                 alex_layers, xa, plain_alex, artifact):
    """Phase 6(b): ``kernel=`` on the user's entry points. Each forward's
    top-1 must equal the plain-version forward's on all 128 images, and
    "auto" must launch what the committed table says. Device-busy time is
    the profiler's, of a forward whose input already lies on the card."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.models import packed_apply
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

    results = {}
    plain_top = plain_probs.argmax(-1)
    for k in ("auto", "residual", "bgemm", "mxu", "s2d"):
        interp = Interpreter(spec, layers, kernel=k, device=dev)
        interp.predict(x[:8])  # warm: the first call builds, not counted
        reset_launches()
        probs = interp.predict(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        agree = int((probs.argmax(-1) == plain_top).sum())
        check(np.isfinite(probs).all() and probs.shape == (128, 1000),
              f"QuickNet kernel={k}: output {probs.shape}")
        check(agree == 128, f"QuickNet kernel={k}: top-1 agreement with the "
              f"plain path {agree}/128")
        if k == "auto":
            want = expected_launches("quicknet", 128)
            check(counts == want, f"QuickNet kernel=auto launches {counts}, "
                  f"the committed table says {want}")
        b = benchmark_model("quicknet", batch=128, iters=10, warmup=2,
                            repeats=3, kernel=k, device=dev)
        busy = profile_forward(lambda: interp(x_dev), top=0)
        results[f"quicknet/{k}"] = {"launches": counts,
                                    "images_per_s": b["images_per_sec"],
                                    "latency_ms": b["latency_ms_p50"],
                                    "device_busy_ms": busy}
        print(f"[kernel=] QuickNet b128 Interpreter(kernel={k!r}): "
              f"(block, bgemm, split-K) launches {counts}, top-1 agreement "
              f"with the plain path {agree}/128; benchmark_model "
              f"{b['images_per_sec']:.1f} images/s, p50 "
              f"{b['latency_ms_p50']:.3f} ms, device busy {ms_text(busy)} "
              f"per forward [{card}]", flush=True)
    plain_a = plain_alex.argmax(-1)
    for k in ("auto", "bgemm", "mxu"):
        def forward():
            return packed_apply(alex, alex_layers, xa, kernel=k,
                                domain="packed")
        forward()
        reset_launches()
        probs = forward()
        torch.cuda.synchronize()
        counts = launch_counts()
        agree = int((probs.argmax(-1) == plain_a).sum().item())
        check(bool(torch.isfinite(probs).all()), f"AlexNet kernel={k}")
        check(agree == 128, f"packed BinaryAlexNet kernel={k}: top-1 "
              f"agreement with the plain path {agree}/128")
        if k == "auto":
            want = expected_launches("binary_alexnet", 128, "packed")
            check(counts == want, f"packed BinaryAlexNet kernel=auto "
                  f"launches {counts}, the committed table says {want}")
        b = benchmark_model("binary_alexnet", batch=128, iters=10, warmup=2,
                            repeats=3, kernel=k, domain="packed", device=dev)
        busy = profile_forward(forward, top=0)
        results[f"binary_alexnet_packed/{k}"] = {
            "launches": counts, "images_per_s": b["images_per_sec"],
            "latency_ms": b["latency_ms_p50"], "device_busy_ms": busy}
        print(f"[kernel=] packed BinaryAlexNet b128 packed_apply(kernel="
              f"{k!r}): (block, bgemm, split-K) launches {counts}, top-1 "
              f"agreement with the plain path {agree}/128; benchmark_model "
              f"{b['images_per_sec']:.1f} images/s, p50 "
              f"{b['latency_ms_p50']:.3f} ms, device busy {ms_text(busy)} "
              f"per forward [{card}]", flush=True)
    b = benchmark_model(artifact_path=artifact, batch=128, iters=10,
                        warmup=2, repeats=3, device=dev)
    mem = {k: b[k] for k in ("weights_mb", "input_mb", "act_peak_mb",
                             "peak_hbm_mb")}
    check(all(v > 0 for v in mem.values()) and b["model"] == "quicknet_graph",
          f"benchmark_model(artifact_path=): {b}")
    print(f"[kernel=] benchmark_model(artifact_path=) on phase 5's "
          f"self-contained artifact ({b['model']}): "
          f"{b['images_per_sec']:.1f} images/s, {json.dumps(mem)} [{card}]",
          flush=True)
    results["artifact"] = {"images_per_s": b["images_per_sec"], **mem}
    return results


# Phase 3(b): the compiled forward. Gates of the benchmark's readings.
COMPILED_BENCH_RUNS = 3  # benchmark_model calls on QuickNet b128, one process
COMPILED_SPREAD_LIMIT = 1.05  # max / min of their images/s
# Their p50 over one compiled call alone, timed by CUDA events: late in
# the default run's process the profiler read a call about 15% short while
# the CUDA events held (the ``[busy]`` lines), so the gates read the
# events.
COMPILED_BUSY_LIMIT = 1.15


def eager_p50_ms(forward, iters=20, repeats=5):
    """The eager forward's latency as ``benchmark_model`` read it before the
    forward was compiled: CUDA events around ``repeats`` windows of
    ``iters`` eager forwards, the median window over ``iters`` (paced by
    the host where it enqueues slower than the card runs)."""
    import numpy as np
    import torch

    forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            forward()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def one_call_ms(call, repeats=5):
    """The card's time for one ``call()`` issued to an idle card: CUDA
    events around it on the current stream, the median of ``repeats``: the
    denominator of the busy gates. Where a call issues several steps it
    holds the host's issuing too."""
    import numpy as np
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def busy_readings(dev, card, spec, layers, label):
    """The denominator of the busy gates read two ways side by side, at one
    point of the process: a compiled QuickNet b128 bf16 ``Interpreter``
    call's device time by the profiler (three traces) and the same call
    alone by CUDA events (three readings, each the median of five).
    Returns the median of the CUDA-event readings."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import device_busy_ms

    interp = Interpreter(spec, layers, device=dev)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        0, 1, (128, *spec.input_size, 3)).astype(np.float32)).to(dev)
    x_in = interp.input_buffer(tuple(x.shape), x.dtype).copy_(x)
    interp(x_in)
    busy = [device_busy_ms(lambda: interp(x_in)) for _ in range(3)]
    alone = [one_call_ms(lambda: interp(x_in)) for _ in range(3)]
    print(f"[busy] {label}: QuickNet b128 bf16 compiled Interpreter, device "
          f"busy of one call by the profiler "
          f"{[None if b is None else round(b, 4) for b in busy]} ms; one call "
          f"alone by CUDA events {[round(a, 4) for a in alone]} ms [{card}]",
          flush=True)
    return float(np.median(alone))


def compiled_phase(dev, card, spec, layers, alex, alex_layers, spec8,
                   layers8_np):
    """Phase 3(b) (``--compiled-only`` builds and runs it alone): the
    forward compiled into one CUDA graph per input shape and dtype
    (``runtime.compiled``) behind ``Interpreter`` and ``benchmark_model``.
    Returns the (block, bgemm, split-K) launches of one call of each
    compiled path."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.kernels import debug_checks
    from compute_engine_tpu_torch.models import packed_apply
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import (benchmark_model,
                                                            device_busy_ms,
                                                            time_forward)
    from compute_engine_tpu_torch.runtime.compiled import CompiledForward

    t_phase = time.perf_counter()
    crng = np.random.default_rng(9)  # this phase's own inputs
    paths = {}

    def images(batch, size):
        return torch.from_numpy(crng.normal(0, 1, (batch, *size, 3)).astype(
            np.float32)).to(dev)

    qn = Interpreter(spec, layers, device=dev)
    qn32 = Interpreter(spec, layers, compute_dtype=torch.float32, device=dev)
    qn8 = Interpreter(spec8, layers8_np, device=dev)
    alex_packed = CompiledForward(
        lambda x: packed_apply(alex, alex_layers, x, domain="packed",
                                   device=dev), dev)
    # (label, compiled call, the same forward eagerly, input, launches)
    cases = [
        ("quicknet b128 bf16", qn,
         lambda x: packed_apply(spec, qn.layers, x, device=dev),
         images(128, spec.input_size), expected_launches("quicknet", 128)),
        ("quicknet b128 float32", qn32,
         lambda x: packed_apply(spec, qn32.layers, x,
                                compute_dtype=torch.float32, device=dev),
         images(128, spec.input_size), expected_launches("quicknet", 128)),
        ("binary_alexnet b128 packed domain", alex_packed,
         lambda x: packed_apply(alex, alex_layers, x, domain="packed",
                                   device=dev),
         images(128, alex.input_size),
         expected_launches("binary_alexnet", 128, "packed")),
        ("quicknet int8 pipeline b128", qn8,
         lambda x: packed_apply(spec8, qn8.layers, x, device=dev),
         images(128, spec.input_size), (0, 16, 0)),
        ("quicknet b1 bf16", qn,
         lambda x: packed_apply(spec, qn.layers, x, device=dev),
         images(1, spec.input_size), expected_launches("quicknet", 1)),
    ]
    busy = {}
    for label, run, eager, x, want in cases:
        outs, launched = [], []
        for _ in range(2):  # the call that captures, then a replay
            reset_launches()
            outs.append(run(x))
            torch.cuda.synchronize()
            launched.append(launch_counts())
        ref = eager(x)
        check(all(c == want for c in launched), f"compiled {label}: "
              f"launches {launched} per call, expected {want}")
        check(all(o.dtype == ref.dtype and torch.equal(o, ref)
                  for o in outs), f"compiled {label}: output differs from "
              f"the eager packed_apply (max |diff| "
              f"{max(max_abs_diff(o, ref) for o in outs)})")
        check(outs[0].data_ptr() != outs[1].data_ptr(),
              f"compiled {label}: two calls returned one tensor")
        paths[f"compiled {label}"] = launched[1]
        compile_s = run.compile_s[(tuple(x.shape), x.dtype)]
        buf = run.input_buffer(x.shape, x.dtype)
        buf.copy_(x)
        busy[label] = (device_busy_ms(lambda: eager(x)),
                       device_busy_ms(lambda: run(buf)))
        print(f"[compiled] {label}: first call (warm-up, capture, replay) "
              f"{compile_s:.3f} s; (block, bgemm, split-K) launches per call "
              f"{launched[1]} (expected {want}); output {TOLERANCE} equal to "
              f"the eager packed_apply; device busy eager "
              f"{ms_text(busy[label][0])}, compiled call "
              f"{ms_text(busy[label][1])} per forward [{card}]", flush=True)

    # Weights are read where they lie: negate one block's filter in place,
    # its packed words (which the block kernel reads) and its +-1 form.
    x = cases[0][3]
    before = qn(x)
    name = next(k for k, v in qn.layers.items()
                if v.get("kind") == "bconv")
    entry = qn.layers[name]
    saved = {k: entry[k].clone() for k in ("packed_filter", "filter_pm1")}
    entry["packed_filter"].copy_(~saved["packed_filter"])
    entry["filter_pm1"].copy_(-saved["filter_pm1"])
    changed, ref = qn(x), packed_apply(spec, qn.layers, x, device=dev)
    for k, v in saved.items():
        entry[k].copy_(v)
    restored = qn(x)
    check(torch.equal(changed, ref) and not torch.equal(changed, before),
          f"compiled forward after {name}'s filter changed in place: "
          "differs from the eager forward on the changed weights, or did "
          "not change")
    check(torch.equal(restored, before), "compiled forward after the "
          "filter was restored")
    print(f"[compiled] weights read in place: {name}'s filter negated with "
          "copy_ (packed words and +-1 form), the next replay equals the "
          "eager forward on the changed weights and differs from the one "
          "before; restored, it equals the first again", flush=True)

    # predict pads its last chunk to the compiled shape.
    xs = cases[0][3][:100].cpu().numpy()
    got = qn.predict(xs, batch_size=64)
    tail = np.concatenate([xs[64:], np.zeros_like(xs[:28])])
    want = np.concatenate([
        packed_apply(spec, qn.layers, chunk, device=dev).cpu().numpy()
        for chunk in (xs[:64], tail)])[:100]
    check(np.array_equal(got, want), "Interpreter.predict in chunks of 64 "
          "differs from the eager forward of the same chunks")
    keys = sorted(shape[0] for shape, _ in qn.compile_s)
    check(keys == [1, 64, 128], f"compiled batch shapes {keys}")
    with debug_checks():
        try:
            qn(x)
            raised = None
        except RuntimeError as e:
            raised = str(e)
    check(raised and "debug_checks" in raised, "a compiled call inside "
          f"kernels.debug_checks() did not raise: {raised}")
    print(f"[compiled] Interpreter.predict(100 images, batch_size=64) pads "
          f"its last chunk, equal to the eager forward of the same chunks: "
          f"graphs at batch {keys}; a call inside "
          "kernels.debug_checks() raises RuntimeError", flush=True)
    del qn32, qn8, alex_packed, cases, outs, ref, changed, restored, before

    # benchmark_model: three readings of QuickNet b128, the eager p50 first.
    eager_ms = eager_p50_ms(lambda: packed_apply(spec, qn.layers, x,
                                                 device=dev))
    print(f"[compiled] quicknet b128 bf16 eager forwards (CUDA events "
          f"around windows of 20): p50 {eager_ms:.4f} ms, "
          f"{128 / eager_ms * 1e3:.1f} images/s; device busy "
          f"{ms_text(busy['quicknet b128 bf16'][0])} [{card}]", flush=True)
    qn_layers = qn.layers
    del qn
    runs = []
    for i in range(COMPILED_BENCH_RUNS):
        b = benchmark_model("quicknet", batch=128, iters=20, warmup=3,
                            repeats=5, device=dev, device_busy=True)
        runs.append(b)
        print(f"[compiled] benchmark_model quicknet b128 bf16, run {i + 1}: "
              f"p50 {b['latency_ms_p50']:.4f} ms, {b['images_per_sec']:.1f} "
              f"images/s, device busy {ms_text(b['device_busy_ms'])}, "
              f"compile_s {b['compile_s']:.3f}, peak_hbm_mb "
              f"{b['peak_hbm_mb']} [{card}] {json.dumps(b)}", flush=True)
    rates = [b["images_per_sec"] for b in runs]
    check(max(rates) / min(rates) <= COMPILED_SPREAD_LIMIT,
          f"benchmark_model's images/s spread {max(rates) / min(rates):.4f}"
          f" > {COMPILED_SPREAD_LIMIT}: {rates}")
    alone = busy_readings(dev, card, spec, layers, "after phases 1-3")
    for b in runs:
        check(b["latency_ms_p50"] <= COMPILED_BUSY_LIMIT * alone,
              f"compiled p50 {b['latency_ms_p50']:.4f} ms > "
              f"{COMPILED_BUSY_LIMIT} x one call alone {alone:.4f} ms (CUDA "
              f"events; the profiler's device busy "
              f"{ms_text(b['device_busy_ms'])})")
    # The other compiled paths, by benchmark_model's timer.
    for label, forward, x in (
            ("quicknet b1 bf16",
             lambda x: packed_apply(spec, qn_layers, x, device=dev),
             images(1, spec.input_size)),
            ("binary_alexnet b128 packed domain",
             lambda x: packed_apply(alex, alex_layers, x, domain="packed",
                                   device=dev),
             images(128, alex.input_size))):
        eager_ms = eager_p50_ms(lambda: forward(x))
        t = time_forward(forward, x, iters=20, repeats=5, device_busy=True)
        print(f"[compiled] {label}: eager p50 {eager_ms:.4f} ms; compiled "
              f"(time_forward, benchmark_model's timer) p50 "
              f"{t['latency_ms_p50']:.4f} ms, {t['images_per_sec']:.1f} "
              f"images/s, device busy {ms_text(t['device_busy_ms'])}, "
              f"compile_s {t['compile_s']:.3f} [{card}]", flush=True)
    torch.cuda.empty_cache()
    print(f"[compiled] phase 3(b): {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return paths


# Phase 6(c): the models the default run trains by the accuracy protocol
# (``--train-only --models a,b`` trains the ones named).
TRAIN_MODELS = ("quicknet", "birealnet18", "binary_alexnet",
                "binary_densenet28")


DETERMINISM_STEPS = 3


def same_training(name, dev):
    """Whether two short trainings of the zoo model ``name`` by the fixture
    protocol, from one seed, end in the same weights bit for bit (the JAX
    package's training is a function of its seed)."""
    import numpy as np

    from compute_engine_tpu_torch.models import (get_model, init_model,
                                                 train_briefly)
    from compute_engine_tpu_torch.models.train import make_prototypes
    from compute_engine_tpu_torch.scripts import accuracy_fixtures as af

    spec = get_model(name)
    protos = make_prototypes(1000, spec.input_size, af.N_CLASSES[name])

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [np.asarray(tree)]

    runs = [leaves(train_briefly(
        spec, init_model(spec, seed=0), steps=DETERMINISM_STEPS,
        batch=af.TRAIN_BATCH, seed=0, num_classes=af.N_CLASSES[name],
        protos=protos, clip_norm=af.CLIP_NORM.get(name), device=dev)[0])
        for _ in range(2)]
    return all(np.array_equal(a, b) for a, b in zip(*runs))


def training_phase(dev, card, models=TRAIN_MODELS):
    """Phase 6(c): each of ``models`` at full width and depth, trained
    briefly on the card, then its float oracle against the packed float32,
    bfloat16, true-int8 and packed-domain paths over 512 images, each at its
    own operand precision (``scripts.accuracy_fixtures.record``), gated by
    the JAX package's per-model bounds. Returns the records and the (block, bgemm, split-K) launches of
    each model's run, counted from 0 just before it."""
    import numpy as np

    from compute_engine_tpu_torch.scripts import accuracy_fixtures as af

    records, paths, failed = {}, {}, []
    for name in models:
        check(same_training(name, dev), f"{name}: two trainings from one "
              "seed gave different weights")
        print(f"[train] {name}: two trainings of {DETERMINISM_STEPS} steps "
              "from one seed end in the same weights, bit for bit",
              flush=True)
        t0 = time.perf_counter()
        reset_launches()
        rec = af.run_model(name, device=dev)
        counts = launch_counts()
        paths[f"accuracy {name}"] = counts
        records[name] = rec
        info = rec["train_loss"]
        print(f"[train] {name} 224x224, {af.N_CLASSES[name]} classes: "
              f"{af.TRAIN_STEPS[name]} Adam+STE steps of batch "
              f"{af.TRAIN_BATCH} on the card, "
              f"{rec['seconds_per_train_step']:.4f} s per step (numpy data "
              f"included), loss {info['loss_first']:.4f} -> "
              f"{info['loss_last']:.4f}; oracle top-1 "
              f"{rec['oracle']['top1_accuracy']:.4f}; (block, bgemm, "
              f"split-K) launches {counts}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        print(json.dumps({"accuracy_224": {"_meta": af.meta(card),
                                           name: rec}}), flush=True)
        gates = af.GATES[name]
        for k in af.PATHS:
            p, ex = rec["paths"][k], rec["paths"][k]["exact_oracle"]
            print(f"[accuracy] {name} {k}: top-1 agreement with the float "
                  f"oracle at {p['oracle_operands']} operands "
                  f"{p['top1_agreement']:.4f} (gate "
                  f"{gates['min_agreement'][k]}), dprob p99 "
                  f"{p['dprob_p99']:.4g} (gate {gates['dprob_p99'][k]}), max "
                  f"{p['dprob_max']:.4g}; against the float32 oracle "
                  f"{ex['top1_agreement']:.4f}, p99 {ex['dprob_p99']:.4g} "
                  f"[{card}]", flush=True)
        check(np.isfinite(info["loss_last"])
              and info["loss_last"] < info["loss_first"],
              f"{name}: training did not lower the loss: {info}")
        check(counts[0] + counts[1] > 0, f"{name}: no kernel launched")
        failed += af.check_record(name, rec)
    # Every model is recorded before the gates fail the phase.
    check(not failed, "accuracy gates missed: " + "; ".join(failed))
    return records, paths


def float32_phase(dev, card, bench_bf16):
    """Phase 6(d): the float32 QuickNet forward, run with TF32 off, timed
    beside the bf16 one."""
    import torch

    from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

    b = benchmark_model("quicknet", batch=128, iters=10, warmup=2,
                        repeats=3, compute_dtype=torch.float32, device=dev)
    print(f"[float32] QuickNet b128 float32 stream (TF32 off in the call): "
          f"{b['images_per_sec']:.1f} images/s, p50 "
          f"{b['latency_ms_p50']:.3f} ms; bfloat16 in this run "
          f"{bench_bf16['images_per_sec']:.1f} images/s, p50 "
          f"{bench_bf16['latency_ms_p50']:.3f} ms [{card}]", flush=True)
    return b


# Phase 7: shapes and meshes. QuickNet's b128 binary convs at sections 2 and
# 3 (14x14x256 and 7x7x512) for tp_bconv2d; the block kernel also at every
# section's shape as each mesh's data group and model slot see it.
MULTI_TP_SHAPES = [(128, 14, 14, 256), (128, 7, 7, 512)]
MULTI_TP_SLOTS = (2, 4)
MULTI_MESHES = [(2, 1), (1, 2), (2, 2)]
MULTI_MESHES_4 = [(4, 1), (1, 4)]  # where four cards are visible
# float32 against the single-device Interpreter: the binary layers are
# exact and the float convs on channel slices measured no difference on the
# H100, so the gate sits far below a typical probability (1e-3 of 1000
# classes); the kernels themselves are held torch.equal to the plain
# versions on every mesh.
MULTI_PROB_TOL = 1e-5
MULTI_BATCH = 128


CASE_C_LIMIT_S = 300  # one run of case C on cards; a hang fails the run


class watchdog:
    """Inside the block the process dumps every thread's stack and exits
    (code 1) once ``seconds`` pass: an NCCL replay whose peers never replay
    waits on the card for ever, and no exception reaches Python."""

    def __init__(self, seconds, what):
        self.seconds, self.what = seconds, what

    def __enter__(self):
        print(f"[multi] {self.what}: at most {self.seconds} s", flush=True)
        faulthandler.dump_traceback_later(self.seconds, exit=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        return False


def multi_block_shards():
    """(images, slots) of the block kernel's launches on every mesh phase 7
    may run: a data group's share of the batch, and the model slots that
    split its output channels; also the tp_bconv2d slot counts at b128."""
    meshes = MULTI_MESHES + MULTI_MESHES_4
    return sorted({(MULTI_BATCH // dp, tp) for dp, tp in meshes}
                  | {(MULTI_BATCH, s) for s in MULTI_TP_SLOTS})


def mesh_devices(n):
    """``n`` slots and a label saying which: distinct cards where the visible
    ones cover them, else ``cuda:0`` ``n`` times (``device_slots``)."""
    from compute_engine_tpu_torch.parallel.mesh import device_slots

    return device_slots(n)


def expected_sharded_launches(model, batch, mesh_shape, domain="float",
                              kernel="auto"):
    """(block, bgemm, split-K) launches of one sharded forward of the zoo
    ``model`` at global ``batch`` over a (dp, tp) mesh: each data group runs
    batch / dp images; a binary layer that ``partition.shards_layer`` shards
    runs on every model slot at its shard's shape, any other one once at
    its own; each by the runtime's dispatch (``select.layer_lowering``,
    ``select.layer_launches``) at that shape."""
    from compute_engine_tpu_torch.kernels import select
    from compute_engine_tpu_torch.models import get_model
    from compute_engine_tpu_torch.models.shapes import binary_layer_modes
    from compute_engine_tpu_torch.parallel.partition import shards_layer

    dp, tp = mesh_shape
    counts = [0, 0, 0]
    for kind, r, dom, out_kind in binary_layer_modes(get_model(model),
                                                      batch // dp):
        if dom != domain:
            continue
        width = "units" if kind == "dense" else "c_out"
        copies = 1
        if r.get("groups", 1) == 1 and shards_layer(r[width], tp, out_kind):
            r, copies = dict(r, **{width: r[width] // tp}), tp
        low = select.layer_lowering(kernel, r, dom, out_kind)
        for i, n in enumerate(select.layer_launches(low, r)):
            counts[i] += dp * copies * n
    return tuple(counts)


def expect_trip(call, match):
    """Run ``call``, which must raise the debug check named by ``match``;
    returns the message."""
    import torch

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        check(match in str(e), f"debug check: expected {match!r}, got {e}")
        return str(e)
    raise RuntimeError(f"FAILED: the {match!r} debug check did not trip")


def multi_device_child(root):
    """Phase 7 in a child process, ``chip_smoke.py --multi-only`` with the
    package of ``root`` (the kernels it loads are already built): prints its
    lines and returns the launches of each sharded path, its last line."""
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--multi-only", "--root", root],
                         capture_output=True, text=True, timeout=900)
    print(run.stdout, end="", flush=True)
    check(run.returncode == 0, f"phase 7 exited {run.returncode}:\n"
          f"{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])["launches_by_path"]


def multi_device_phase(dev, card, tmp):
    """Phase 7: the multi-device path on the card (``--multi-only`` alone).
    Returns the (block, bgemm, split-K) launches of each sharded path."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.converter import save_artifact
    from compute_engine_tpu_torch.core import BConv2DParams, Padding, bitpack
    from compute_engine_tpu_torch.core.transforms import (
        OutputTransform, compute_output_thresholds, fuse_output_transform)
    from compute_engine_tpu_torch.kernels import debug_checks, select
    from compute_engine_tpu_torch.kernels.bgemm import bgemm, bgemm_plain
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)
    from compute_engine_tpu_torch.models import (convert_model, get_model,
                                                 init_model, packed_apply)
    from compute_engine_tpu_torch.ops import bconv2d
    from compute_engine_tpu_torch.parallel import make_mesh, tp_bconv2d
    from compute_engine_tpu_torch.parallel.collective import NcclLinks
    from compute_engine_tpu_torch.parallel.partition import sharded_apply
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import time_calls
    from compute_engine_tpu_torch.runtime.distributed_serving import (
        MultiHostServer, ShardedInterpreter)
    from compute_engine_tpu_torch.runtime.multiprocess import launch_workers

    t_phase = time.perf_counter()
    mrng = np.random.default_rng(7)  # this phase's own draws
    cards = torch.cuda.device_count()
    paths = {}
    print(f"[multi] {cards} card(s) visible; a mesh takes distinct cards "
          "where they cover it, else cuda:0 repeated", flush=True)

    # (a) tp_bconv2d at full width, every mode and output kind, held to the
    # single-slot op with the GEMM lowering, with the kernel and again with
    # the plain GEMM; and the block kernel on each shard's shape.
    def pm1(shape):
        return np.where(mrng.normal(size=shape) < 0, -1.0, 1.0).astype(
            np.float32)

    modes = (("gather", ("float", "bitpacked")),
             ("sharded", ("float", "bitpacked")),
             ("pipelined", ("float", "int8", "bitpacked")))
    for n, h, w, c in MULTI_TP_SHAPES:
        xp = bitpack(torch.from_numpy(pm1((n, h, w, c))).to(dev))
        filt = pm1((c, 3, 3, c))
        post_mul = (mrng.uniform(0.2, 2.0, c)
                    * mrng.choice([-1.0, 1.0], c)).astype(np.float32)
        post_bias = mrng.uniform(-3, 3, c).astype(np.float32)
        params = BConv2DParams(channels_in=c, padding=Padding.SAME,
                               pad_value=1)
        cases = {}
        for kind in ("float", "int8", "bitpacked"):
            if kind == "bitpacked":
                flip = np.where(post_mul >= 0, 1.0, -1.0)
                wf, t = filt * flip[:, None, None, None], OutputTransform(
                    thresholds=compute_output_thresholds(post_mul, post_bias,
                                                         9 * c))
            else:
                wf, t = filt, fuse_output_transform(
                    post_mul, post_bias, 9 * c,
                    output_scale=0.05 if kind == "int8" else None)
            cases[kind] = bitpack(torch.from_numpy(wf).to(dev)), t
        for slots in MULTI_TP_SLOTS:
            devices, where = mesh_devices(slots)
            mesh = make_mesh((1, slots), devices=devices)
            for mode, kinds in modes:
                for kind in kinds:
                    wp, t = cases[kind]
                    want = bconv2d(xp, wp, t, params, kind, kernel="bgemm")
                    log = []
                    reset_launches()
                    got = tp_bconv2d(xp, wp, t, params, mesh,
                                     output_kind=kind, kernel="bgemm",
                                     mode=mode, log=log).join(dev)
                    torch.cuda.synchronize()
                    counts = launch_counts()
                    plain = tp_bconv2d(xp, wp, t, params, mesh,
                                       output_kind=kind, kernel="bgemm",
                                       mode=mode, gemm=bgemm_plain).join(dev)
                    per = n // slots if mode == "pipelined" else n
                    one = select.layer_launches("bgemm", dict(
                        c_in=c, c_out=c // slots, fh=3, fw=3, m=per * h * w))
                    calls = slots * slots if mode == "pipelined" else slots
                    exp = tuple(calls * v for v in one)
                    label = f"tp_bconv2d {mode} {kind} S={slots} {h}x{w}x{c}"
                    check(torch.equal(got, want), f"{label}: != the "
                          f"single-slot op (max |diff| "
                          f"{max_abs_diff(got, want)})")
                    check(torch.equal(plain, want), f"{label}: the plain "
                          "GEMM on the shards != the single-slot op")
                    check(counts == exp, f"{label}: launches {counts}, "
                          f"layer_launches at the shard shape says {exp}")
                    kinds_seen = {r["kind"] for r in log}
                    check(kinds_seen == {"pipelined": {"ppermute"},
                                         "gather": {"all_gather"},
                                         "sharded": set()}[mode],
                          f"{label}: collectives {kinds_seen}")
                    paths[label] = counts
                    print(f"[multi] {label} on {where}: equal to the "
                          f"single-slot op and to the plain GEMM on the "
                          f"shards ({TOLERANCE}); (block, bgemm, split-K) "
                          f"{counts}; collectives {sorted(kinds_seen)}, "
                          f"{sum(r['bytes'] for r in log)} bytes",
                          flush=True)
    shards = multi_block_shards()
    for shape in QUICKNET_BLOCKS:
        c = shape[-1]
        p = BConv2DParams(channels_in=c, padding=Padding.SAME, pad_value=1)
        for images, slots in shards:
            for dt in (torch.bfloat16, torch.float32):
                add = slots == 1  # a channel slice launches without the add
                x, pf, tr = block_case(mrng, (images, *shape[1:]), dev, dt,
                                       False, c // slots)
                got = binary_residual_block(x, pf, tr, p, has_residual=add)
                want = binary_residual_block_plain(x, pf, tr, p,
                                                   has_residual=add)
                check(torch.equal(got, want), f"residual_block "
                      f"{images}x{shape[1]}x{shape[2]}x{c} -> {c // slots} "
                      f"{str(dt)[6:]} (add {add}): kernel != plain")
        print(f"[multi] residual_block {'x'.join(map(str, shape[1:]))} at "
              f"(images, output channels) "
              f"{[(i, c // s) for i, s in shards]}, bf16 and float32, the "
              f"add where every channel stays: equal to the plain version "
              f"({TOLERANCE})", flush=True)

    # (b) ShardedInterpreter, compiled (runtime.compiled): QuickNet 224x224
    # b128 at float32 and bf16 against the single-device Interpreter, and
    # each call against the eager sharded forward; the segment plan on one
    # card under _split_at_slots; packed BinaryAlexNet at (1, 2).
    spec = get_model("quicknet")
    t0 = time.perf_counter()
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    batch = MULTI_BATCH
    xq = mrng.normal(0, 1, (batch, *spec.input_size, 3)).astype(np.float32)
    x_dev = torch.from_numpy(xq).to(dev)
    x2_dev = torch.from_numpy(np.random.default_rng(10).normal(
        0, 1, (batch, *spec.input_size, 3)).astype(np.float32)).to(dev)
    ref = {dt: Interpreter(spec, layers, compute_dtype=dt, device=dev)(x_dev)
           for dt in (torch.float32, torch.bfloat16)}
    print(f"[multi] QuickNet init + convert + reference forwards "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    meshes = MULTI_MESHES + (MULTI_MESHES_4 if cards >= 4 else [])
    runs = [(shape, dt, False, "quicknet") for shape in meshes
            for dt in (torch.float32, torch.bfloat16)]
    runs += [((1, 2), torch.bfloat16, True, "quicknet"),
             ((1, 2), torch.bfloat16, False, "binary_alexnet")]
    alex = get_model("binary_alexnet")
    alayers = convert_model(alex, init_model(alex, seed=0, randomize_bn=True))
    xa = torch.from_numpy(mrng.normal(0, 1, (batch, *alex.input_size, 3))
                          .astype(np.float32)).to(dev)
    xa2 = torch.from_numpy(np.random.default_rng(11).normal(
        0, 1, (batch, *alex.input_size, 3)).astype(np.float32)).to(dev)
    ref_a = packed_apply(alex, alayers, xa, domain="packed", device=dev)
    def sharded_run(shape, dt, split, model, on_cards):
        n = shape[0] * shape[1]
        # The segment plan runs on one card, where (C) is otherwise never
        # reached.
        one = torch.device("cuda", 0) if dev.type == "cuda" else dev
        devices, where = (mesh_devices(n) if not split else
                          ([one] * n, f"one card, {one} x {n}"))
        mesh = make_mesh(shape, devices=devices)
        name = str(dt)[6:]
        if model == "quicknet":
            interp = ShardedInterpreter(spec, layers, mesh=mesh,
                                        compute_dtype=dt,
                                        _split_at_slots=split)
            xs, want_ref, domain = (x_dev, x2_dev), ref[dt], "float"
        else:
            interp = ShardedInterpreter(alex, alayers, mesh=mesh,
                                        domain="packed")
            xs, want_ref, domain = (xa, xa2), ref_a, "packed"
        label = (f"ShardedInterpreter {model} b{batch} {shape} {name}"
                 + (" packed domain" if domain == "packed" else "")
                 + (" _split_at_slots" if split else ""))
        exp = expected_sharded_launches(model, batch, shape, domain)
        launched = []
        for _ in range(3):
            reset_launches()
            probs = interp(x_dev if model == "quicknet" else xa)
            torch.cuda.synchronize()
            launched.append(launch_counts())
        check(all(c == exp for c in launched), f"{label}: launches "
              f"{launched} per call, layer_launches at the shard shapes "
              f"says {exp}")
        key = (tuple(xs[0].shape), xs[0].dtype)
        plan = interp.plan
        steps, graphs = plan["host_steps"][key], plan["graphs"][key]
        one_card = len({d.index or 0 for d in devices}) == 1
        check(not one_card or split or (plan["case"], steps) == ("A", 1),
              f"{label}: case {plan['case']}, {steps} host steps per call on "
              "one card (expected case A, 1)")
        check(not on_cards or (plan["case"], graphs, steps) == ("C", n, n),
              f"{label}: case {plan['case']}, {graphs} graphs and {steps} "
              f"host steps per call on {n} cards (expected C, one graph and "
              "one host step per card)")
        probs = probs.to(dev)
        check(tuple(probs.shape) == (batch, want_ref.shape[-1]) and bool(
            torch.isfinite(probs).all()), f"{label}: output")
        agree = (probs.argmax(-1) == want_ref.argmax(-1)).sum().item()
        dprob = (probs - want_ref).abs().max().item()
        if dt == torch.float32 or domain == "packed":
            check(agree == batch and (domain == "packed"
                                      or dprob <= MULTI_PROB_TOL),
                  f"{label}: top-1 {agree}/{batch}, max |dprob| {dprob} "
                  f"against the single-device forward (gate "
                  f"{MULTI_PROB_TOL})")

        def eager(x, **kw):
            return sharded_apply(interp.spec, interp.layers, x, interp.mesh,
                                 groups=interp._groups,
                                 **{**interp._kw, **kw}).to(dev)

        wants = [eager(x) for x in xs]
        plain = eager(xs[0], residual_block=binary_residual_block_plain,
                      gemm=bgemm_plain)
        check(torch.equal(probs, wants[0]), f"{label}: != the eager "
              f"sharded_apply (max |dprob| {max_abs_diff(probs, wants[0])})")
        check(torch.equal(probs, plain), f"{label}: != the same forward "
              f"with the plain versions on the shards (max |dprob| "
              f"{max_abs_diff(probs, plain)})")
        # Two batches alternated: a stale static buffer, or a copy between
        # segments ordered wrongly, would show.
        del probs
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        for i in range(4):
            got = interp(xs[i % 2]).to(dev)
            check(torch.equal(got, wants[i % 2]), f"{label}: alternated "
                  f"call {i} != the eager forward of its batch")
        del got
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated(dev) <= held, f"{label}: "
              f"allocated {held} bytes before four calls, "
              f"{torch.cuda.memory_allocated(dev)} after")
        if model == "quicknet":
            # Weights are read where they lie: one slot's shard of a block's
            # filter negated in place (packed words and +-1 form).
            lname = next(k for k, v in interp.layers.items()
                         if v.get("kind") == "bconv")
            slot = (0, shape[1] - 1)
            entry = interp.layers[lname]
            shards = {k: entry[k].shard(slot)
                      for k in ("packed_filter", "filter_pm1")}
            saved = {k: v.clone() for k, v in shards.items()}
            for k, v in shards.items():
                v.copy_(~v if k == "packed_filter" else -v)
            changed, want_changed = interp(xs[0]).to(dev), eager(xs[0])
            for k, v in shards.items():
                v.copy_(saved[k])
            check(torch.equal(changed, want_changed)
                  and not torch.equal(changed, wants[0]), f"{label}: after "
                  f"{lname}'s shard on slot {slot} was negated in place the "
                  "replay differs from the eager forward, or did not change")
            check(torch.equal(interp(xs[0]).to(dev), wants[0]),
                  f"{label}: after the shard was restored")
            del changed, want_changed
        del plain
        paths[label] = launched[-1]
        text = (f"[multi] {label} on {where}: case {plan['case']}, {graphs} "
                f"graph(s) and {steps} host step(s) per call, compile_s "
                f"{interp.compile_s[key]:.3f}; (block, bgemm, split-K) "
                f"{launched[-1]} per call over 3 calls; {TOLERANCE} equal to "
                "the eager sharded_apply and to the plain versions, over 4 "
                "alternated calls of two batches"
                + (" and after a filter shard changed in place"
                   if model == "quicknet" else "")
                + f"; top-1 {agree}/{batch} against the single-device "
                f"forward, max |dprob| {dprob:.3g}")
        # The bytes the transfers between slots move in one call: the
        # eager forward of each group through its own links, logged.
        log, per = [], batch // shape[0]
        for d, g in enumerate(interp._groups):
            interp._group_forward(g, xs[0][d * per:(d + 1) * per].to(g.home),
                                  log=log)
        torch.cuda.synchronize()
        moved = {kind: sum(r["bytes"] for r in log if r["kind"] == kind)
                 for kind in ("all_gather", "broadcast")}
        text += (f"; between slots per call ("
                 f"{'NCCL' if interp.links else 'copies'}): all_gather "
                 f"{moved['all_gather']} bytes, broadcast "
                 f"{moved['broadcast']} bytes")
        if dt == torch.bfloat16 or on_cards:
            eager_ms = eager_p50_ms(lambda: eager(xs[0]))
            buf = interp.input_buffer(*key)
            x_in = xs[0] if buf is None else buf.copy_(xs[0])
            timed = time_calls(interp, x_in, iters=20, repeats=5)
            p50, busy = timed["latency_ms_p50"], timed["device_busy_ms"]
            alone = one_call_ms(lambda: interp(x_in))
            text += (f"; eager p50 {eager_ms:.4f} ms, compiled p50 "
                     f"{p50:.4f} ms (differenced windows of 20 and 40 calls, "
                     f"median of 5), {timed['images_per_sec']:.1f} images/s, "
                     f"device busy of one call {ms_text(busy)} (profiler), "
                     f"one call alone {alone:.4f} ms (CUDA events)")
            if one_card:
                check(p50 <= COMPILED_BUSY_LIMIT * alone,
                      f"{label}: compiled p50 {p50:.4f} ms > "
                      f"{COMPILED_BUSY_LIMIT} x one call alone {alone:.4f} ms "
                      f"by CUDA events (the profiler's device busy "
                      f"{ms_text(busy)})")
        print(f"{text} [{card}]", flush=True)

    for shape, dt, split, model in runs:
        n = shape[0] * shape[1]
        on_cards = (not split and shape[1] > 1
                    and len({d.index for d in mesh_devices(n)[0]}) == n)
        guard = (watchdog(CASE_C_LIMIT_S, f"case C on {n} cards, {shape} "
                          f"{str(dt)[6:]}") if on_cards
                 else contextlib.nullcontext())
        with guard:
            sharded_run(shape, dt, split, model, on_cards)
    torch.cuda.empty_cache()
    print(f"[multi] peak_hbm_mb after (b): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} [{card}]",
          flush=True)

    # (c) MultiHostServer over two hosts of two slots, batch 128, float32
    # (case C over NCCL on four cards).
    devices, where = mesh_devices(4)
    hosts = {"h0": devices[:2], "h1": devices[2:]}
    more = mrng.normal(0, 1, (3 * batch, *spec.input_size, 3)).astype(
        np.float32)
    requests = np.concatenate([xq, more])
    t0 = time.perf_counter()
    with (watchdog(CASE_C_LIMIT_S, "MultiHostServer on four cards")
          if len(set(devices)) > 1 else contextlib.nullcontext()), \
            MultiHostServer(spec, layers, host_devices=hosts, tp=2,
                         batch_size=batch, max_delay_ms=2000,
                         heartbeat_timeout_s=3600,
                         compute_dtype=torch.float32) as server:
        check(server._interp.mesh.shape == {"data": 2, "model": 2},
              f"server mesh {server._interp.mesh.shape}")
        futs = [server.submit(im) for im in requests]
        served = np.stack([f.result(timeout=300) for f in futs])
        torch.cuda.synchronize()
        first_mb = torch.cuda.memory_allocated(dev) / 2 ** 20
        compiles = [(server._interp.case, server._interp.compile_s)]
        direct = np.concatenate([
            server._interp(requests[i:i + batch]).cpu().numpy()
            for i in range(0, len(requests), batch)])
        check(np.array_equal(served, direct), "server: a served row differs "
              "from the direct forward on the same mesh (max |diff| "
              f"{np.abs(served - direct).max()})")
        server.monitor.heartbeat("h0")
        server.monitor._last_seen["h1"] = server.monitor._clock() - 7200
        server.monitor.check_now()
        check(server.reshard_count == 1 and server.monitor.alive_hosts()
              == ["h0"] and server._interp.mesh.devices.size == 2,
              f"server after losing h1: {server.reshard_count} reshards, "
              f"mesh {server._interp.mesh.shape}")
        futs = [server.submit(im) for im in xq]
        after = np.stack([f.result(timeout=300) for f in futs])
        compiles.append((server._interp.case, server._interp.compile_s))
        ref32 = ref[torch.float32].cpu().numpy()
        agree = int((after.argmax(-1) == ref32.argmax(-1)).sum())
        check(agree == batch, f"server after the reshard: top-1 "
              f"{agree}/{batch} against the Interpreter")
        server.monitor.heartbeat("h1")
        server.monitor.check_now()
        check(server._interp.mesh.devices.size == 4 and
              server.reshard_count == 2 and not server.degraded,
              f"server after h1's recovery: mesh "
              f"{server._interp.mesh.shape}")
        futs = [server.submit(im) for im in requests[:batch]]
        again = np.stack([f.result(timeout=300) for f in futs])
        check(np.array_equal(again, served[:batch]), "server after h1's "
              "recovery: a served row differs from the same request on the "
              "first (2, 2) mesh")
        compiles.append((server._interp.case, server._interp.compile_s))
        torch.cuda.synchronize()
        last_mb = torch.cuda.memory_allocated(dev) / 2 ** 20
        check(all(len(c) == 1 for _, c in compiles), "server: each mesh "
              f"compiled once, at its first batch: {compiles}")
        check(last_mb <= first_mb * 1.05, f"server: {last_mb:.1f} MiB "
              f"allocated on the (2, 2) mesh after two reshards, "
              f"{first_mb:.1f} before them")
        stats = server.engine.stats
    del server  # its interpreter and communicators go with it
    print(f"[multi] MultiHostServer on {where} (h0: slots 0-1, h1: slots "
          f"2-3, tp 2, float32, batch {batch}): {len(requests)} requests "
          f"equal to the direct forward on the (2, 2) mesh; h1 lost -> 1 "
          f"reshard, mesh (1, 2), {batch} requests top-1 {agree}/{batch} "
          f"against the Interpreter; h1 back -> "
          f"mesh (2, 2), {batch} requests equal to the first mesh's; "
          f"{stats.batches} batches, fill {stats.mean_batch_fill:.3f}, "
          f"{time.perf_counter() - t0:.2f} s; compiled at the first batch "
          f"of each mesh (case, compile_s): "
          f"{[(c, round(next(iter(v.values())), 3)) for c, v in compiles]}; "
          f"allocated {first_mb:.1f} MiB on the first mesh, {last_mb:.1f} "
          f"after two reshards; peak_hbm_mb "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} [{card}]",
          flush=True)

    # (d) launch_workers on the card.
    artifact = os.path.join(tmp, "quicknet_multi.npz")
    save_artifact(artifact, layers, "quicknet")
    groups = ([("nccl", 2, "NCCL, 2 ranks on 2 cards")] if cards >= 2 else
              [("nccl", 1, "NCCL, 1 rank on cuda:0"),
               ("gloo", 2, "Gloo, 2 ranks on cuda:0, gathered through "
                           "the host")])
    t0 = time.perf_counter()
    started = []
    for backend, ranks, text in groups:
        out_dir = os.path.join(tmp, f"workers_{backend}")
        os.makedirs(out_dir)
        started.append((text, launch_workers(
            ranks, artifact=artifact, model="quicknet", out_dir=out_dir,
            batch=8, seed=0, backend=backend, device=dev.type)))
    x8 = np.random.default_rng(0).normal(
        0, 1, (8, *spec.input_size, 3)).astype(np.float32)
    want8 = packed_apply(spec, layers, x8, compute_dtype=torch.float32,
                         device=dev).cpu().numpy()
    for text, (procs, outs) in started:
        for p in procs:
            try:
                log, _ = p.communicate(timeout=300)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            check(p.returncode == 0, f"worker ({text}) exited "
                  f"{p.returncode}:\n{log.decode()[-2000:]}")
        for out in outs:
            got = np.load(out)
            diff = float(np.abs(got - want8).max())
            check(diff <= 1e-5 and (got.argmax(-1) == want8.argmax(-1)).all(),
                  f"worker ({text}): max |diff| {diff} against the "
                  "single-process float32 packed_apply")
        print(f"[multi] launch_workers({len(procs)}) {text}: every rank holds "
              f"the whole batch of 8, within {diff:.3g} (gate 1e-5) of the "
              "single-process float32 packed_apply on the card, top-1 equal",
              flush=True)
    print(f"[multi] workers {time.perf_counter() - t0:.2f} s", flush=True)

    # (e) The debug builds: silent and equal at the main-path shapes; each
    # check trips on a broken call by raising; the context survives.
    t0 = time.perf_counter()
    blocks, gemms = [], []
    for shape in QUICKNET_BLOCKS:
        x, pf, tr = block_case(mrng, shape, dev, torch.bfloat16, False)
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=1)
        blocks.append((x, pf, tr, p, binary_residual_block(x, pf, tr, p)))
    for _, m, kw, n, kind in ALEXNET_GEMMS:
        lhs, rhs, kwargs = gemm_case(mrng, m, kw, n, kind, dev)
        gemms.append((lhs, rhs, kwargs, bgemm(lhs, rhs, **kwargs)))
    m, kw, n = RAGGED_GEMM
    lhs, rhs, kwargs = gemm_case(mrng, m, kw, n, "bitpacked", dev)
    splitk = (lhs, rhs, kwargs, bgemm(lhs, rhs, max_block_kw=SPLITK_BLOCK_KW,
                                      **kwargs))
    zeros_l = torch.zeros((m, kw), dtype=torch.int32, device=dev)
    zeros_r = torch.zeros((kw, n), dtype=torch.int32, device=dev)
    ones, ones_pf, ones_tr = block_case(mrng, (4, 14, 14, 64), dev,
                                        torch.bfloat16, True)
    ones = torch.ones_like(ones)
    ones_pf = torch.zeros_like(ones_pf)  # all bits 0: every weight +1
    ones_p = BConv2DParams(channels_in=64, padding=Padding.SAME, pad_value=1)
    trips = []
    with debug_checks():
        for x, pf, tr, p, want in blocks:
            check(torch.equal(binary_residual_block(x, pf, tr, p), want),
                  f"debug build: residual_block {tuple(x.shape)} != the "
                  "default build")
        for lhs_, rhs_, kwargs_, want in gemms:
            check(torch.equal(bgemm(lhs_, rhs_, **kwargs_), want),
                  f"debug build: bgemm {tuple(lhs_.shape)} != the default "
                  "build")
        check(torch.equal(bgemm(splitk[0], splitk[1],
                                max_block_kw=SPLITK_BLOCK_KW, **splitk[2]),
                          splitk[3]), "debug build: split-K != default")
        torch.cuda.synchronize()
        trips.append(expect_trip(lambda: bgemm(
            zeros_l, zeros_r, out_kind="accum",
            _debug_total_bits=32 * kw - 32), "total_bits"))
        trips.append(expect_trip(lambda: bgemm(
            zeros_l, zeros_r, out_kind="accum", max_block_kw=SPLITK_BLOCK_KW,
            _debug_total_bits=32 * kw - 32), "split-K"))
        thr = torch.full((n,), -1, dtype=torch.int32, device=dev)
        trips.append(expect_trip(lambda: bgemm(
            lhs, rhs, thresholds=thr, out_kind="bitpacked",
            _debug_vote_n=128), "beyond N"))
        trips.append(expect_trip(lambda: binary_residual_block(
            ones, ones_pf, ones_tr, ones_p, _debug_k=9 * 64 - 32),
            "one-padding"))
    # The context is still usable: default-build calls give their results.
    x, pf, tr, p, want = blocks[0]
    check(torch.equal(binary_residual_block(x, pf, tr, p), want),
          "after the trips: residual_block != its earlier result")
    lhs_, rhs_, kwargs_, want = gemms[0]
    check(torch.equal(bgemm(lhs_, rhs_, **kwargs_), want),
          "after the trips: bgemm != its earlier result")
    torch.cuda.synchronize()
    print(f"[multi] debug builds: residual_block at the 4 QuickNet shapes, "
          f"bgemm at the 6 BinaryAlexNet shapes and forced split-K raise "
          f"nothing and equal the default build ({TOLERANCE}); tripped on "
          f"purpose, each raised: {trips}; default-build calls after them "
          f"still give their results; {time.perf_counter() - t0:.2f} s",
          flush=True)
    # (f) The entry points of __graft_entry_torch__.py.
    paths.update(graft_entry_phase(dev, cards))
    # The servers' interpreters (a server and its monitor refer to each
    # other) release their NCCL communicators here, not at exit.
    with watchdog(60, "releasing the NCCL communicators"):
        gc.collect()
    live = [o for o in gc.get_objects()
            if isinstance(o, NcclLinks) and not o.closed]
    check(not live, f"{len(live)} NCCL communicator set(s) not released "
          "after phase 7")
    print(f"[multi] phase 7: {time.perf_counter() - t_phase:.2f} s; every "
          "NCCL communicator set released", flush=True)
    return paths


def graft_entry_phase(dev, cards):
    """Phase 7(f): ``entry()`` through the compiled ``Interpreter`` against
    the eager ``packed_apply``, and ``dryrun_multichip`` on 2 slots and, with
    four cards, on 4 (case C at (2, 2) over NCCL), under the time limit of
    case C. Returns the launches of ``entry()``'s forward."""
    import torch

    import __graft_entry_torch__ as graft
    from compute_engine_tpu_torch.models import packed_apply

    t0 = time.perf_counter()
    fn, (x,) = graft.entry()
    reset_launches()
    got = fn(x)
    torch.cuda.synchronize()
    launched = launch_counts()
    want = packed_apply(fn.spec, fn.layers, x, device=dev)
    exp = expected_launches("quicknet", 8)
    check(tuple(got.shape) == (8, 1000) and bool(torch.isfinite(got).all())
          and torch.equal(got, want), "entry(): the compiled forward of "
          "the zeros batch is not finite (8, 1000) probabilities equal to "
          "the eager packed_apply")
    check(launched == exp, f"entry(): launches {launched}, "
          f"expected_launches says {exp}")
    print(f"[graft] entry(): QuickNet b8 zeros through the compiled "
          f"Interpreter, (8, 1000) finite, {TOLERANCE} equal to the eager "
          f"packed_apply; (block, bgemm, split-K) {launched}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del fn, got, want
    for n in (2, 4) if cards >= 4 else (2,):
        t0 = time.perf_counter()
        with watchdog(CASE_C_LIMIT_S, f"dryrun_multichip({n})"):
            r = graft.dryrun_multichip(n)
        print(f"[graft] dryrun_multichip({n}) on {r['slots']}: mesh "
              f"{r['mesh']}, case {r['case']}, plan {r['plan']}; output "
              f"{tuple(r['out'].shape)} finite; tp_bconv2d gather == sharded "
              f"== pipelined at {r['tp_modes']}; {r['reshards']} reshard(s) "
              f"and answered after; {time.perf_counter() - t0:.2f} s",
              flush=True)
    return {"entry() quicknet b8 compiled": launched}


# Phase 8: the baseline configurations the tools phase times (BASELINE.md's
# five: four here and BinaryDenseNet-45 served, for TOOLS_SERVING_S seconds).
TOOLS_CONFIGS = [("quicknet_small", 1), ("quicknet", 128),
                 ("quicknet_large", 128), ("birealnet18", 128)]
TOOLS_SERVING_S = 10.0
SECTION_PCT_LIMIT = 105.0  # above it a section's floors are wrong


# Phase 8(c) runs in a process of its own: QuickNet's sections at b128, and
# the (block, bgemm, split-K) launches of that run, written to argv[1].
SECTION_CHILD = """
import json, sys
from compute_engine_tpu_torch.kernels.bgemm import bgemm
from compute_engine_tpu_torch.kernels.residual import binary_residual_block
from compute_engine_tpu_torch.scripts import section_profile
report = section_profile.profile(128, iters=20, repeats=5)
with open(sys.argv[1], "w") as f:
    json.dump({"report": report, "launches": [
        binary_residual_block.launches, bgemm.launches,
        bgemm.splitk_launches]}, f)
"""


def tools_phase(dev, card):
    """Phase 8: the repo's tools on the card (``--tools-only`` alone): the
    user-flow example, the baseline matrix at its five configurations, the
    QuickNet section profile at batch 128 and the scaling report over the
    slots there. Each prints its JSON and is gated where it can be. Returns
    the (block, bgemm, split-K) launches of each tool's run."""
    import numpy as np
    import torch

    from compute_engine_tpu_torch.examples import e2e_smoke
    from compute_engine_tpu_torch.scripts import baseline_matrix as bm
    from compute_engine_tpu_torch.scripts import section_profile as sp
    from compute_engine_tpu_torch.scripts import tp_scaling_report as tsr

    t_phase = time.perf_counter()
    paths = {}
    # (a) The example: every lowering equal to the reference, bit for bit.
    reset_launches()
    out = e2e_smoke.run(dev)
    torch.cuda.synchronize()
    paths["e2e_smoke"] = launch_counts()
    bad = e2e_smoke.unequal(out)
    print(json.dumps({"e2e_smoke": {
        "kernels": list(e2e_smoke.KERNELS), "unequal": bad,
        "launches": paths["e2e_smoke"],
        "dequantized_values": sorted(out["dequantized"].unique().tolist())}}),
        flush=True)
    check(not bad, f"e2e_smoke: outputs differ from the reference: {bad}")
    check(paths["e2e_smoke"][1] > 0, "e2e_smoke: the bgemm lowering "
          "launched no GEMM")
    print(f"[tools] e2e_smoke: bconv2d float and bitpacked outputs of "
          f"{list(e2e_smoke.KERNELS[1:])} equal to 'reference' "
          f"({TOLERANCE}); (block, bgemm, split-K) launches "
          f"{paths['e2e_smoke']}", flush=True)

    # (b) The baseline matrix.
    rows = {}
    for model, batch in TOOLS_CONFIGS:
        reset_launches()
        rows[f"{model}@{batch}"] = bm.bench_config(model, batch, device=dev)
        paths[f"baseline_matrix {model}@{batch}"] = launch_counts()
    reset_launches()
    served = bm.bench_serving(duration_s=TOOLS_SERVING_S, device=dev)
    paths["baseline_matrix serving"] = launch_counts()
    rows[f"{served['model']}@serving"] = served
    print(json.dumps({"baseline_matrix": rows, "card": card}), flush=True)
    for name, rec in rows.items():
        if "requests_per_sec" in rec:
            print(f"[tools] baseline {name}: {rec['requests_per_sec']:.1f} "
                  f"requests/s, p50 {rec['request_p50_ms']:.2f} ms, p99 "
                  f"{rec['request_p99_ms']:.2f} ms, fill "
                  f"{rec['mean_batch_fill']:.3f}, {rec['batches']} batches, "
                  f"every result equal to the direct forward: "
                  f"{rec['results_equal_direct']} [{card}]", flush=True)
        else:
            print(f"[tools] baseline {name}: p50 {rec['latency_ms_p50']:.3f} "
                  f"ms, {rec['images_per_sec']:.1f} images/s, device busy "
                  f"{ms_text(rec['device_busy_ms'])} per forward, compile_s "
                  f"{rec['compile_s']:.2f} [{card}]", flush=True)
    bad = bm.bad_rows(rows)
    check(not bad, f"baseline matrix rows not finite and positive, or "
          f"served results unequal: {bad}")

    # (c) The section profile, in a process of its own, as a user runs it.
    # In this process, after phases 1-7, the profiler's device time of the
    # stem prefixes read 0.26-0.53 ms where a fresh process reads 0.61 ms
    # on every run (cause not found), and the prefix differencing then gave
    # a row a negative time.
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "section_profile.json")
        run = subprocess.run(
            [sys.executable, "-c", SECTION_CHILD, out], timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(run.returncode == 0, f"section profile: its process exited "
              f"with {run.returncode}")
        with open(out) as f:
            child = json.load(f)
    report = child["report"]
    paths["section_profile"] = tuple(child["launches"])
    print(json.dumps({"section_profile": report, "card": card}), flush=True)
    for r in report["sections"]:
        pct = r["pct_of_bound"]
        print(f"[tools] section {r['name']}: {r['ms']:.4f} ms device busy, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_kind']}), "
              f"{'-' if pct is None else f'{pct:.1f}'}% of bound [{card}]",
              flush=True)
    bad = sp.bad_rows(report, SECTION_PCT_LIMIT)
    check(not bad, f"section profile: rows with no positive time or above "
          f"{SECTION_PCT_LIMIT}% of their bound: {bad}")

    # (d) The scaling report.
    reset_launches()
    dp = tsr.dp_scaling(device=dev)
    tp = tsr.tp_modes(device=dev)
    paths["tp_scaling_report"] = launch_counts()
    print(json.dumps({"tp_scaling": {"dp_scaling": dp, "tp_modes": tp},
                      "card": card}), flush=True)
    for r in dp:
        print(f"[tools] dp {r['dp']} on {r['slots']} (case {r['case']}, "
              f"{r['host_steps']} host step(s), compile_s "
              f"{r['compile_s']:.3f}): {r['latency_ms']:.4f} ms, "
              f"{r['images_per_sec']:.1f} images/s, device busy "
              f"{ms_text(r['device_busy_ms'])}, scaling efficiency "
              f"{r['scaling_efficiency']:.3f} [{card}]", flush=True)
    for r in tp:
        print(f"[tools] tp_bconv2d {r['mode']} tp {r['tp']} on {r['slots']}: "
              f"{r['latency_ms']:.4f} ms (one slot "
              f"{r['single_slot_ms']:.4f} ms), equal to one slot: "
              f"{r['equal_single_slot']}, to gather: "
              f"{r['bit_exact_vs_gather']} [{card}]", flush=True)
    check(all(r["equal_single_slot"] and r["bit_exact_vs_gather"]
              for r in tp), "tp_bconv2d: a mode differs from the "
          "single-slot op")
    check(all(np.isfinite(r["images_per_sec"]) and r["images_per_sec"] > 0
              for r in dp), f"dp scaling rows: {dp}")
    print(f"[tools] phase 8: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return paths


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = os.path.dirname(os.path.abspath(__file__))
    if "--root" in args:  # the package of another checkout
        root = os.path.abspath(args[args.index("--root") + 1])
    sys.path.insert(0, root)
    try:
        import compute_engine_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    import numpy as np

    from compute_engine_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f"; package from {os.path.relpath(root)}", flush=True)

    # 1. Build.
    t0 = time.perf_counter()
    # The kernels' debug builds too (phase 7): one nvcc each, all at once.
    logs = _build.build_all(debug=tuple(
        name for name in ("bgemm", "residual_block", "stem_conv_pool",
                          "transition_conv_pool")
        if name in _build.sources()))
    print(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    # The int8 pipeline's phases draw from a generator of their own, so that
    # the earlier phases keep the inputs they have always had.
    rng8 = np.random.default_rng(8)
    if "--kernel-times" in args:
        kernel_times(rng, dev, card)
        return 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(args, root, dev, card, device_kind, rng, rng8, tmp)
    finally:
        shutil.rmtree(tmp)


def run_phases(args, root, dev, card, device_kind, rng, rng8, tmp):
    import numpy as np
    import torch

    from compute_engine_tpu_torch.core import BConv2DParams, Padding
    from compute_engine_tpu_torch.interop import layers_from_numpy
    from compute_engine_tpu_torch.kernels.bgemm import bgemm, bgemm_plain
    from compute_engine_tpu_torch.kernels.residual import (
        binary_residual_block, binary_residual_block_plain)
    from compute_engine_tpu_torch.models import (MODELS, Int8Tensor,
                                                 PackedBuilder, convert_model,
                                                 get_model, init_model,
                                                 packed_apply,
                                                 prepare_runtime_arrays)
    from compute_engine_tpu_torch.runtime import Interpreter
    from compute_engine_tpu_torch.runtime.benchmark import benchmark_model

    if "--serve-only" in args:
        bench = benchmark_model("quicknet", batch=128, iters=10, warmup=3,
                                repeats=5, device=dev)
        print(json.dumps({"launches_by_path": serving_phase(
            root, dev, card, bench["images_per_sec"], tmp)[0]}))
        return 0
    if "--select-only" in args:
        selection_phase(dev, card)
        return 0
    if "--zero-pad-only" in args:
        print(json.dumps({"zero_pad": zero_pad_phase(dev, card)}))
        return 0
    if "--dense-only" in args:
        print(json.dumps({"dense": dense_phase(dev, card)}))
        return 0
    if "--stem-only" in args:
        print(json.dumps({"stem": stem_phase(dev, card)}))
        return 0
    if "--transition-only" in args:
        print(json.dumps({"transition": transition_phase(dev, card)}))
        return 0
    if "--reactnet-only" in args:
        print(json.dumps({"reactnet": reactnet_phase(dev, card)}))
        return 0
    if "--train-only" in args:
        models = TRAIN_MODELS
        if "--models" in args:
            models = tuple(args[args.index("--models") + 1].split(","))
        print(json.dumps({"launches_by_path": training_phase(
            dev, card, models)[1]}))
        return 0
    if "--tools-only" in args:
        print(json.dumps({"launches_by_path": tools_phase(dev, card)}))
        return 0
    if "--multi-only" in args:
        print(json.dumps({"launches_by_path": multi_device_phase(dev, card,
                                                                 tmp)}),
              flush=True)
        # Leaving the process must not wait on a card for ever: dump the
        # stacks and exit 1 if it takes two minutes.
        faulthandler.dump_traceback_later(120, exit=True)
        return 0
    if "--compiled-only" in args:
        spec = get_model("quicknet")
        alex = get_model("binary_alexnet")
        alex_layers = layers_from_numpy(prepare_runtime_arrays(convert_model(
            alex, init_model(alex, seed=0, randomize_bn=True))), dev)
        spec8, _, layers8_np = int8_quicknet(dev)
        print(json.dumps({"launches_by_path": compiled_phase(
            dev, card, spec, convert_model(spec, init_model(
                spec, seed=0, randomize_bn=True)), alex, alex_layers, spec8,
            layers8_np)}))
        return 0

    # 2. Kernel against its plain version.
    max_err = 0.0
    cases = [(s, torch.bfloat16) for s in QUICKNET_BLOCKS + [RAGGED]]
    cases += [(RAGGED, torch.float32), (ODD, torch.bfloat16),
              (ODD, torch.float32)]
    for shape, dtype in cases:
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=1)
        for label, identity, residual in (("identity", True, True),
                                          ("random", False, True),
                                          ("no-residual", False, False)):
            x, pf, tr = block_case(rng, shape, dev, dtype, identity)
            got = binary_residual_block(x, pf, tr, p, has_residual=residual)
            torch.cuda.synchronize()
            want = binary_residual_block_plain(x, pf, tr, p,
                                               has_residual=residual)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"residual_block {shape} {dtype} {label}: kernel != plain "
                  f"(max |diff| {err})")
            print(f"[compare] residual_block {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]} {label}: equal ({TOLERANCE})", flush=True)
    # Without the add the channel counts may differ: BinaryAlexNet's
    # float-domain conv3 and conv5 at batch 128.
    for shape, c_out in ALEXNET_FLOAT_CONVS:
        p = BConv2DParams(channels_in=shape[-1], padding=Padding.SAME,
                          pad_value=1)
        x, pf, tr = block_case(rng, shape, dev, torch.bfloat16, False, c_out)
        got = binary_residual_block(x, pf, tr, p, has_residual=False)
        torch.cuda.synchronize()
        want = binary_residual_block_plain(x, pf, tr, p, has_residual=False)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"residual_block {shape} -> {c_out} no-residual: kernel != "
              f"plain (max |diff| {err})")
        print(f"[compare] residual_block {'x'.join(map(str, shape))} -> "
              f"{c_out} channels bfloat16 no-residual: equal ({TOLERANCE})",
              flush=True)
    zero_pad_compare(np.random.default_rng(17), dev)
    dense_compare(np.random.default_rng(45), dev)
    stem_compare(np.random.default_rng(23), dev)
    transition_compare(dev)
    react_compare(dev)

    gemm_err = {"bgemm": 0.0, "bgemm_splitk": 0.0, "bgemm_int8": 0.0}
    gemm_cases = [(f"{name} {m}x{kw}x{n}", (m, kw, n, kind), {})
                  for name, m, kw, n, kind in ALEXNET_GEMMS]
    gemm_cases += [(f"{name} {m}x{kw}x{n}", (m, kw, n, kind), {})
                   for name, m, kw, n, kind in EDGE_GEMMS]
    gemm_cases += [(f"QuickNet {name} {m}x{kw}x{n}", (m, kw, n, "int8"),
                    {"form": "bgemm_int8"})
                   for name, m, kw, n in QUICKNET_INT8_GEMMS]
    gemm_cases += [(f"{label} {m}x{kw}x{n}", (m, kw, n, "float"),
                    {"bn": True})
                   for label, m, kw, n in react_pointwise_gemms(128)]
    m, kw, n = RAGGED_GEMM
    gemm_cases += [(f"ragged {m}x{kw}x{n}", (m, kw, n, kind), {})
                   for kind in ("accum", "float", "int8", "bitpacked")]
    gemm_cases.append((f"ragged {m}x{kw}x{n} (KW, N) operand",
                       (m, kw, n, "accum"), {"n_major": False}))
    gemm_cases.append((f"ragged {m}x{kw}x{n} unaligned operands",
                       (m, kw, n, "float"), {"unaligned": True}))
    gemm_cases += [(f"split-K {m}x{kw}x{n} block_kw {SPLITK_BLOCK_KW}",
                    (m, kw, n, kind), {"max_block_kw": SPLITK_BLOCK_KW})
                   for kind in ("accum", "float", "int8", "bitpacked")]
    for label, (m, kw, n, kind), opts in gemm_cases:
        if opts.get("bn"):
            lhs, rhs, kwargs = bn_gemm_case(rng, m, kw, n, dev)
        else:
            lhs, rhs, kwargs = gemm_case(
                rng8 if opts.get("form") == "bgemm_int8" else rng, m, kw, n,
                kind, dev, n_major=opts.get("n_major", True))
        if opts.get("unaligned"):  # one word into a larger allocation
            lhs = torch.cat([lhs.new_zeros(1), lhs.reshape(-1)])[1:].view(m, kw)
            rhs = torch.cat([rhs.new_zeros(1), rhs.t().reshape(-1)])[1:].view(
                n, kw).t()
            check(lhs.data_ptr() % 16 and rhs.data_ptr() % 16,
                  "the operands should not be 16-byte aligned")
        got = bgemm(lhs, rhs, max_block_kw=opts.get("max_block_kw", 1024),
                    **kwargs)
        torch.cuda.synchronize()
        want = bgemm_plain(lhs, rhs, **kwargs)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        form = opts.get("form", "bgemm_splitk" if "max_block_kw" in opts
                        else "bgemm")
        gemm_err[form] = max(gemm_err[form], err)
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"bgemm {label} {kind}: kernel != plain (max |diff| {err})")
        print(f"[compare] bgemm {label} {kind}: equal ({TOLERANCE})",
              flush=True)

    if "--sweep-residual" in args:
        sweep_residual(rng, dev, card)
        return 0
    t0 = time.perf_counter()
    spec8, params8, layers8_np = int8_quicknet(dev)
    print(f"[quicknet int8] init + calibrate (2 batches of 8 on the card) + "
          f"convert {time.perf_counter() - t0:.2f} s", flush=True)
    compare_integer_layers(rng8, layers8_np, dev)
    if "--compare-only" in args:
        print("chip_smoke: --compare-only, stopping after phase 2")
        return 0

    # 3. The main paths. QuickNet at batch 128 through the Interpreter.
    spec = get_model("quicknet")
    t0 = time.perf_counter()
    layers = convert_model(spec, init_model(spec, seed=0, randomize_bn=True))
    interp = Interpreter(spec, layers)
    x = rng.normal(0, 1, (128, *spec.input_size, 3)).astype(np.float32)
    print(f"[quicknet] init + convert + load {time.perf_counter() - t0:.2f} s",
          flush=True)
    reset_launches()
    probs = interp.predict(x)
    torch.cuda.synchronize()
    qn_counts = launch_counts()
    launches = qn_counts[0]
    qn_want = expected_launches("quicknet", 128)
    check(qn_counts == qn_want, f"QuickNet forward: (block, bgemm, split-K) "
          f"launches {qn_counts}, the committed table says {qn_want}")
    check(probs.shape == (128, 1000), f"output shape {probs.shape}")
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(np.allclose(probs.sum(-1), 1.0, atol=1e-3), "rows do not sum to 1")
    plain = packed_apply(spec, interp.layers, x,
                         residual_block=binary_residual_block_plain)
    plain = plain.cpu().numpy()
    agree = float((probs.argmax(-1) == plain.argmax(-1)).mean())
    diff = float(np.abs(probs - plain).max())
    print(f"[quicknet] batch 128: (block, bgemm, split-K) launches "
          f"{qn_counts} (the committed table: {qn_want}), top-1 agreement "
          f"with the plain path {agree:.4f}, max |dprob| {diff:.3g}",
          flush=True)
    check(agree == 1.0, f"top-1 agreement with the plain path {agree}")

    # BinaryAlexNet at batch 128 in the packed domain.
    alex = get_model("binary_alexnet")
    t0 = time.perf_counter()
    alex_layers = layers_from_numpy(prepare_runtime_arrays(convert_model(
        alex, init_model(alex, seed=0, randomize_bn=True))), dev)
    xa = torch.from_numpy(rng.normal(0, 1, (128, *alex.input_size, 3))
                          .astype(np.float32)).to(dev)
    print(f"[alexnet] init + convert + load {time.perf_counter() - t0:.2f} s",
          flush=True)
    binary_residual_block.launches = 0
    bgemm.launches = bgemm.splitk_launches = 0
    probs_a = packed_apply(alex, alex_layers, xa, domain="packed")
    torch.cuda.synchronize()
    gemm_launches = bgemm.launches
    counts = (gemm_launches, bgemm.splitk_launches,
              binary_residual_block.launches)
    want = expected_launches("binary_alexnet", 128, "packed")
    alex_want = (want[1], want[2], want[0])
    check(counts == alex_want, "packed BinaryAlexNet: (bgemm, split-K, "
          f"block) launches {counts}, the committed table says {alex_want}")
    check(tuple(probs_a.shape) == (128, 1000),
          f"output shape {tuple(probs_a.shape)}")
    check(bool(torch.isfinite(probs_a).all()), "non-finite probabilities")
    check(bool(torch.allclose(probs_a.sum(-1), torch.ones(128, device=dev),
                              atol=1e-3)), "rows do not sum to 1")
    plain_a = packed_apply(alex, alex_layers, xa, domain="packed",
                           gemm=bgemm_plain,
                           residual_block=binary_residual_block_plain)
    agree_plain = (probs_a.argmax(-1) == plain_a.argmax(-1)).sum().item()
    diff_plain = (probs_a - plain_a).abs().max().item()
    bgemm.launches = 0
    binary_residual_block.launches = 0
    float_a = packed_apply(alex, alex_layers, xa, domain="float")
    torch.cuda.synchronize()
    float_counts = (bgemm.launches, binary_residual_block.launches)
    agree_float = (probs_a.argmax(-1) == float_a.argmax(-1)).sum().item()
    diff_float = (probs_a - float_a).abs().max().item()
    print(f"[alexnet] packed domain, batch 128: (bgemm, split-K, block) "
          f"launches {counts} (the committed table: {alex_want}); "
          f"top-1 agreement with the plain path {agree_plain}/128 (max "
          f"|dprob| {diff_plain:.3g}); with the float domain "
          f"{agree_float}/128 (max |dprob| {diff_float:.3g}; float domain: "
          f"{float_counts[0]} bgemm and {float_counts[1]} residual block "
          "launches)", flush=True)
    check(agree_plain == 128, f"top-1 agreement with the plain path "
          f"{agree_plain}/128")
    check(agree_float == 128, f"top-1 agreement with the float domain "
          f"{agree_float}/128")
    want = expected_launches("binary_alexnet", 128)
    check(float_counts == (want[1], want[0]), "float-domain BinaryAlexNet: "
          f"(bgemm, block) launches {float_counts}, the committed table says "
          f"{(want[1], want[0])}")

    # QuickNet at batch 128 through the true-int8 pipeline. Every binary conv
    # reads the signs off int8 values and writes int8 through the GEMM's
    # epilogue; the block kernel takes no int8 stream.
    layers8 = layers_from_numpy(prepare_runtime_arrays(layers8_np), dev)
    x_dev = torch.from_numpy(x).to(dev)
    add_results = []
    builder_add = PackedBuilder.add

    def counting_add(self, a, b):
        out = builder_add(self, a, b)
        add_results.append(isinstance(out, Int8Tensor))
        return out

    PackedBuilder.add = counting_add
    try:
        binary_residual_block.launches = 0
        bgemm.launches = bgemm.splitk_launches = 0
        logits8 = packed_apply(spec8, layers8, x_dev, return_logits=True)
        torch.cuda.synchronize()
        int8_launches = bgemm.launches
        counts8 = (int8_launches, bgemm.splitk_launches,
                   binary_residual_block.launches)
        adds8 = list(add_results)
    finally:
        PackedBuilder.add = builder_add
    check(counts8 == (16, 0, 0), "int8 QuickNet: 16 bgemm launches and no "
          f"split-K or residual block launch per forward, got {counts8}")
    check(adds8 == [True] * 16, "int8 QuickNet: all 16 adds as int8 ADDs, "
          f"got {sum(adds8)} of {len(adds8)}")
    check(tuple(logits8.shape) == (128, 1000) and logits8.dtype
          == torch.float32 and bool(torch.isfinite(logits8).all()),
          f"int8 QuickNet logits: {tuple(logits8.shape)} {logits8.dtype}")
    plain8 = packed_apply(spec8, layers8, x_dev, return_logits=True,
                          gemm=bgemm_plain,
                          residual_block=binary_residual_block_plain)
    agree8 = (logits8.argmax(-1) == plain8.argmax(-1)).sum().item()
    check(torch.equal(logits8, plain8), "int8 QuickNet: logits differ from "
          "the plain-GEMM forward (max |diff| "
          f"{max_abs_diff(logits8, plain8)})")
    check(agree8 == 128, f"int8 QuickNet: top-1 agreement with the plain "
          f"path {agree8}/128")
    probs8 = torch.softmax(logits8, dim=-1)
    # Not gated: an untrained model's end-to-end agreement with the float
    # domain means little (one sign flip at a binary conv's input, a value
    # within half a quantisation step of zero, changes the prediction).
    float8 = torch.from_numpy(probs).to(dev)
    print(f"[quicknet int8] batch 128: {counts8[0]} bgemm launches (int8 "
          f"out), {counts8[2]} residual block launches, {sum(adds8)} int8 "
          f"ADDs; logits equal to the plain-GEMM forward ({TOLERANCE}), "
          f"top-1 {agree8}/128; against the bf16 float-domain forward of "
          "the same weights (not gated): top-1 agreement "
          f"{(probs8.argmax(-1) == float8.argmax(-1)).sum().item()}/128, "
          f"max |dprob| {(probs8 - float8).abs().max().item():.3g}",
          flush=True)

    # Every zoo model runs on the card in the float domain (batch 4): once
    # with each binary layer by the lowering the committed table chooses,
    # and once with every binary layer on the GEMM ("bgemm"; the
    # zero-padding correction of Bi-RealNet's convs runs on the card only
    # there), each against the same forward with the plain versions.
    for name in MODELS:
        zspec = get_model(name)
        zlayers = layers_from_numpy(prepare_runtime_arrays(convert_model(
            zspec, init_model(zspec, seed=0, randomize_bn=True))), dev)
        xz = torch.from_numpy(rng.normal(0, 1, (4, *zspec.input_size, 3))
                              .astype(np.float32)).to(dev)
        for k in ("auto", "bgemm"):
            reset_launches()
            pz = packed_apply(zspec, zlayers, xz, kernel=k)
            torch.cuda.synchronize()
            zcounts = launch_counts()
            pz_plain = packed_apply(zspec, zlayers, xz, kernel=k,
                                    gemm=bgemm_plain,
                                    residual_block=binary_residual_block_plain)
            zagree = (pz.argmax(-1) == pz_plain.argmax(-1)).sum().item()
            want = expected_launches(name, 4, kernel=k)
            print(f"[zoo] {name} batch 4, float domain, kernel={k!r}: "
                  f"(block, bgemm, split-K) launches {zcounts} (expected "
                  f"{want}), top-1 agreement with the plain path "
                  f"{zagree}/4", flush=True)
            check(bool(torch.isfinite(pz).all())
                  and tuple(pz.shape) == (4, 1000),
                  f"{name} kernel={k}: output {tuple(pz.shape)}, finite "
                  f"{bool(torch.isfinite(pz).all())}")
            check(zcounts == want, f"{name} kernel={k}: launches {zcounts}, "
                  f"the runtime's dispatch says {want}")
            check(k == "auto" or zcounts[1] + zcounts[2] > 0,
                  f"{name}: no GEMM launched under kernel='bgemm'")
            check(zagree == 4, f"{name} kernel={k}: top-1 agreement with the "
                  f"plain path {zagree}/4")

    # 3(b). The compiled forward.
    compiled = compiled_phase(dev, card, spec, layers, alex, alex_layers,
                              spec8, layers8_np)

    # 4. Timing.
    bench = benchmark_model("quicknet", batch=128, iters=10, warmup=3,
                            repeats=5, device=dev)
    print(f"[bench] quicknet b128 bf16: {bench['images_per_sec']:.1f} images/s,"
          f" p50 {bench['latency_ms_p50']:.3f} ms/forward [{card}] "
          f"{json.dumps(bench)}", flush=True)
    profile_forward(lambda: packed_apply(spec, interp.layers, x_dev))
    bench8 = benchmark_model("quicknet", batch=128, iters=10, warmup=3,
                             repeats=5, device=dev, int8_pipeline=True)
    print(f"[bench] quicknet b128 int8 pipeline: "
          f"{bench8['images_per_sec']:.1f} images/s, p50 "
          f"{bench8['latency_ms_p50']:.3f} ms/forward (bf16 float domain in "
          f"this run: {bench['latency_ms_p50']:.3f} ms) [{card}] "
          f"{json.dumps(bench8)}", flush=True)
    profile_forward(lambda: packed_apply(spec8, layers8, x_dev), top=16)
    # The tensor cores' rate at a binary dot product (binary multiply-adds
    # per second; the H100's data sheet gives none for one bit).
    from compute_engine_tpu_torch.kernels.mma_rate import KINDS as MMA_KINDS
    from compute_engine_tpu_torch.kernels.mma_rate import mma_rate

    mma_rates = {}
    for kind in MMA_KINDS:
        mma_rates[kind] = max(mma_rate(kind, iters=4000) for _ in range(2))
        print(f"[mma] {kind}: {mma_rates[kind]:.4g} binary multiply-adds/s "
              f"[{card}]", flush=True)
    int8_rate, one_bit_rate = list(mma_rates.values())[:2]
    print(f"[mma] the one-bit MMA does {one_bit_rate / int8_rate:.2f} times "
          "the binary multiply-adds of the int8 one (the bound takes 8 times "
          f"the int8 peak, {PEAK_ONE_BIT_OPS_PER_S / 2:.4g} multiply-adds/s)",
          flush=True)
    check(one_bit_rate > 6 * int8_rate, "the one-bit MMA should issue at "
          "about the int8 MMA's rate, which the bound's peak assumes")
    shapes = []
    for shape in QUICKNET_BLOCKS:
        n, h, w, c = shape
        t = time_block(rng, shape, dev)
        shapes.append(t)
        before = BLOCK_MS_BEFORE[h]
        print(f"[time] residual_block {n}x{h}x{w}x{c} bf16: kernel "
              f"{t['ms']:.4f} ms (before {before:.4f} ms [{BEFORE_CARD}]), "
              f"plain {t['plain_ms']:.4f} ms, cuDNN bf16 conv "
              f"{t['library_ms']:.4f} ms, a copy of the activation "
              f"{t['copy_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) [{card}]", flush=True)
        check(t["ms"] <= before, f"residual_block {shape}: {t['ms']:.4f} ms "
              f"is slower than the kernel it replaced ({before:.4f} ms)")

    def per_forward(key):
        return sum(BLOCKS_PER_SHAPE * s[key] for s in shapes)

    # BinaryAlexNet: the model in both domains, then each GEMM.
    for domain in ("packed", "float"):
        b = benchmark_model("binary_alexnet", batch=128, iters=10, warmup=3,
                            repeats=5, device=dev, domain=domain)
        print(f"[bench] binary_alexnet b128 bf16 {domain} domain: "
              f"{b['images_per_sec']:.1f} images/s, p50 "
              f"{b['latency_ms_p50']:.3f} ms/forward [{card}] "
              f"{json.dumps(b)}", flush=True)
    profile_forward(lambda: packed_apply(alex, alex_layers, xa,
                                         domain="packed"), top=16)

    gemm_shapes = []
    for name, m, kw, n, kind in ALEXNET_GEMMS:
        g = time_gemm(rng, m, kw, n, kind, dev)
        gemm_shapes.append({"layer": name, **g})
        before = GEMM_MS_BEFORE[name]
        check(g["ms"] <= before, f"bgemm {name}: {g['ms']:.4f} ms is slower "
              f"than the kernel it replaced ({before:.4f} ms)")
        print(f"[time] bgemm {name} M={m} KW={kw} N={n} {kind}: kernel "
              f"{g['ms']:.4f} ms (before {before:.4f} ms [{BEFORE_CARD}]), "
              f"plain {g['plain_ms']:.4f} ms, torch._int_mm "
              f"{g['library_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms "
              f"({g['bound_by']}) [{card}]", flush=True)
    m, kw, n = RAGGED_GEMM
    lhs, rhs, kwargs = gemm_case(rng, m, kw, n, "float", dev)
    bgemm.splitk_launches = 0
    bgemm(lhs, rhs, max_block_kw=SPLITK_BLOCK_KW, **kwargs)
    torch.cuda.synchronize()
    splitk_launches = bgemm.splitk_launches
    check(splitk_launches == 1, f"one split-K launch, got {splitk_launches}")
    splitk = time_gemm(rng, m, kw, n, "float", dev,
                       max_block_kw=SPLITK_BLOCK_KW)
    print(f"[time] bgemm split-K M={m} KW={kw} N={n} float, block_kw "
          f"{SPLITK_BLOCK_KW}: kernel {splitk['ms']:.4f} ms (before "
          f"{SPLITK_MS_BEFORE:.4f} ms [{BEFORE_CARD}]), plain "
          f"{splitk['plain_ms']:.4f} ms, torch._int_mm with N padded to "
          f"{splitk['library_n_padded_to']} {splitk['library_ms']:.4f} ms, "
          f"bound {splitk['bound_ms']:.4f} ms "
          f"({splitk['bound_by']}) [{card}]", flush=True)

    # The int8 pipeline's GEMMs: four launches per shape in a QuickNet
    # forward, int8 out.
    int8_shapes = []
    for name, m8, kw8, n8 in QUICKNET_INT8_GEMMS:
        g = time_gemm(rng8, m8, kw8, n8, "int8", dev)
        int8_shapes.append({"layer": name, **g})
        print(f"[time] bgemm int8 {name} M={m8} KW={kw8} N={n8}: kernel "
              f"{g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms, "
              f"torch._int_mm {g['library_ms']:.4f} ms, bound "
              f"{g['bound_ms']:.4f} ms ({g['bound_by']}) [{card}]",
              flush=True)

    def bound_of_launches(items, weight=1):
        """Launches do not overlap, so the bound of a forward is the sum of
        its launches' bounds; it is named after the side that sets more of
        it."""
        by = {"bytes": 0.0, "operations": 0.0}
        for item in items:
            by[item["bound_by"]] += weight * item["bound_ms"]
        return sum(by.values()), max(by, key=by.get)

    gemm_bound, gemm_bound_by = bound_of_launches(gemm_shapes)
    # The line's numbers are per QuickNet forward: 16 launches, 4 per shape.
    bound_fw, bound_by = bound_of_launches(shapes, BLOCKS_PER_SHAPE)
    int8_bound, int8_bound_by = bound_of_launches(int8_shapes,
                                                  BLOCKS_PER_SHAPE)

    def int8_per_forward(key):
        return sum(BLOCKS_PER_SHAPE * g[key] for g in int8_shapes)

    print(f"[time] bgemm int8 per QuickNet forward (16 launches): kernel "
          f"{int8_per_forward('ms'):.4f} ms, plain "
          f"{int8_per_forward('plain_ms'):.4f} ms, torch._int_mm "
          f"{int8_per_forward('library_ms'):.4f} ms, bound {int8_bound:.4f} "
          f"ms ({int8_bound_by}) [{card}]", flush=True)
    # 5. The serving path.
    served, artifact = serving_phase(root, dev, card,
                                     bench["images_per_sec"], tmp)

    # 6. Selection, kernel= and brief training, at full width.
    selection_phase(dev, card)
    kernel_phase(dev, card, spec, layers, x, x_dev, plain, alex, alex_layers,
                 xa, plain_a, artifact)
    _, trained = training_phase(dev, card)
    float32_phase(dev, card, bench)
    busy_readings(dev, card, spec, layers, "after phase 6")

    # 7. The multi-device path, in a process of its own (``--multi-only``).
    # Late in this process the profiler reads a forward's device time short
    # (the section profile's stem prefixes: 0.26-0.53 ms where a fresh
    # process reads 0.61), and phase 7(b) gates the compiled p50 against
    # the device busy of one call.
    sharded = multi_device_child(root)

    # 8. The repo's tools.
    tools = tools_phase(dev, card)

    kernels = [{
        "name": "residual_block",
        "route": "cuda",
        "source": "compute_engine_tpu_torch/csrc/residual_block.cu",
        "replaces": "compute_engine_tpu/kernels/residual.py:86",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": bound_fw,
        "bound_by": bound_by,
        "library_ms": per_forward("library_ms"),
        "per": "one QuickNet batch-128 forward (16 launches)",
        "launches_by_path": {k: v[0] for k, v in {**served,
                                                   **sharded}.items()},
        "shapes": shapes,
    }, {
        "name": "bgemm",
        "route": "cuda",
        "source": "compute_engine_tpu_torch/csrc/bgemm.cu",
        "replaces": "compute_engine_tpu/kernels/bgemm.py:200",
        "launches": gemm_launches,
        "max_abs_err": gemm_err["bgemm"],
        "ms": sum(g["ms"] for g in gemm_shapes),
        "plain_ms": sum(g["plain_ms"] for g in gemm_shapes),
        "bound_ms": gemm_bound,
        "bound_by": gemm_bound_by,
        "library_ms": sum(g["library_ms"] for g in gemm_shapes),
        "per": "one packed-domain BinaryAlexNet batch-128 forward "
               "(6 launches)",
        "launches_by_path": {k: v[1] for k, v in sharded.items()
                             if " int8 " not in k},
        "shapes": gemm_shapes,
    }, {
        "name": "bgemm_int8",
        "route": "cuda",
        "source": "compute_engine_tpu_torch/csrc/bgemm.cu",
        "replaces": "compute_engine_tpu/kernels/bgemm.py:200",
        "launches": int8_launches,
        "max_abs_err": gemm_err["bgemm_int8"],
        "ms": int8_per_forward("ms"),
        "plain_ms": int8_per_forward("plain_ms"),
        "bound_ms": int8_bound,
        "bound_by": int8_bound_by,
        "library_ms": int8_per_forward("library_ms"),
        "per": "one QuickNet batch-128 forward in the int8 pipeline (16 "
               "launches of the same kernel with its int8 epilogue)",
        "launches_by_path": {k: v[1] for k, v in {**served, **{
            k: v for k, v in sharded.items() if " int8 " in k}}.items()},
        "shapes": int8_shapes,
    }, {
        "name": "bgemm_splitk",
        "route": "cuda",
        "source": "compute_engine_tpu_torch/csrc/bgemm.cu",
        "replaces": "compute_engine_tpu/kernels/bgemm.py:235",
        "launches": splitk_launches,
        "max_abs_err": gemm_err["bgemm_splitk"],
        "ms": splitk["ms"],
        "plain_ms": splitk["plain_ms"],
        "bound_ms": splitk["bound_ms"],
        "bound_by": splitk["bound_by"],
        "library_ms": splitk["library_ms"],
        "launches_by_path": {k: v[2] for k, v in sharded.items()},
        "per": f"one forced split-K call, M={m} KW={kw} N={n} float, "
               f"block_kw {SPLITK_BLOCK_KW} (no zoo shape reaches split-K); "
               "library_ms: torch._int_mm with N padded to "
               f"{splitk['library_n_padded_to']} (it takes N % 8 == 0 only)",
        "shapes": [splitk],
    }]
    print(json.dumps({"mma_rates": mma_rates}))
    # (block, bgemm, split-K) launches of each path of phase 5, counted from
    # 0 just before the path to just after it.
    print(json.dumps({"launches_by_path": {**compiled, **served, **trained,
                                           **sharded, **tools}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
