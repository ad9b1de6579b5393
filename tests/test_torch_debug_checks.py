"""The kernels' debug checks (``kernels.debug``), the counterpart of the
Pallas kernels' ``pl.debug_check`` (``tests/test_debug_checks.py``).

On the CPU the plain versions hold the four invariants inside
``debug_checks()``: an honest call raises nothing, and a call whose
accounting is broken on purpose (a declared ``total_bits`` or K that is
not what was summed, bitpacked votes taken past N) raises, naming the
invariant. The kernels' debug builds (``-DCE_DEBUG_CHECKS``) run only on
the card; ``chip_smoke.py`` phase 7(e) passes and trips each of them there.
Here: the debug build is a library of its own, and ``debug_checks()``
switches the wrappers to it and back.
"""

import threading

import numpy as np
import pytest
import torch

from compute_engine_tpu_torch.core import (BConv2DParams, OutputTransform,
                                           Padding, bitpack)
from compute_engine_tpu_torch.kernels import _build, debug, debug_checks
from compute_engine_tpu_torch.kernels import bgemm as bgemm_mod
from compute_engine_tpu_torch.kernels import residual as residual_mod
from compute_engine_tpu_torch.kernels.bgemm import (MAX_BLOCK_KW, bgemm,
                                                    bgemm_plain,
                                                    check_padding_bits)
from compute_engine_tpu_torch.kernels.residual import (
    binary_residual_block, binary_residual_block_plain)


def _operands(seed=0, m=32, kw=4, n=128):
    rng = np.random.default_rng(seed)
    lhs = rng.integers(-2 ** 31, 2 ** 31, (m, kw), dtype=np.int64)
    rhs = rng.integers(-2 ** 31, 2 ** 31, (kw, n), dtype=np.int64)
    return (torch.from_numpy(lhs.astype(np.int32)),
            torch.from_numpy(rhs.astype(np.int32)), rng)


@pytest.mark.parametrize("out_kind", ["accum", "float", "int8", "bitpacked"])
def test_bgemm_checks_pass_on_every_out_kind(out_kind):
    """No false alarm: random operands, N = 100 (a ragged last word)."""
    lhs, rhs, rng = _operands(n=100)
    n = rhs.shape[1]
    kw = dict(multiplier=rng.uniform(0.5, 2, n).astype(np.float32),
              bias=rng.normal(0, 1, n).astype(np.float32),
              thresholds=rng.integers(-64, 64, n).astype(np.int32))
    want = bgemm_plain(lhs, rhs, out_kind=out_kind, **kw)
    with debug_checks():
        for max_block_kw in (1024, 1):  # one pass, and split-K on the card
            got = bgemm(lhs, rhs, out_kind=out_kind,
                        max_block_kw=max_block_kw, **kw)
            assert torch.equal(got, want)


@pytest.mark.parametrize("kw, name", [(4, "total_bits"),
                                      (MAX_BLOCK_KW + 1, "split-K")])
def test_bgemm_false_total_bits_trips_its_check(kw, name):
    """All-zero operands: every +-1 sum is +32 KW, one word above a
    declared 32 KW - 32 (``test_debug_checks.py``'s broken kernel). The
    check is named as split-K's where the kernel splits K."""
    lhs = torch.zeros((8, kw), dtype=torch.int32)
    rhs = torch.zeros((kw, 16), dtype=torch.int32)
    with debug_checks():
        bgemm(lhs, rhs, out_kind="accum", _debug_total_bits=32 * kw)  # honest
        with pytest.raises(RuntimeError, match=name):
            bgemm(lhs, rhs, out_kind="accum", _debug_total_bits=32 * kw - 32)


def test_bgemm_votes_past_n_trip_the_padding_bit_check():
    """A kernel that votes past N sets bits beyond it in the last word. The
    test takes those votes itself: the plain version over operands widened
    from N = 40 to 64 channels, held to the real N."""
    lhs, rhs, _ = _operands(n=64)
    thr = np.full(64, -1, np.int32)  # every vote is 1
    with debug_checks():
        words = bgemm(lhs, rhs[:, :40], thresholds=thr[:40],
                      out_kind="bitpacked")
        assert int(words[0, 1]) == 0xFF  # channels 32..39, nothing above
        check_padding_bits(words, 40)
        wide = bgemm_plain(lhs, rhs, thresholds=thr, out_kind="bitpacked")
        assert torch.equal(wide[:, 0], words[:, 0])
        with pytest.raises(RuntimeError, match="beyond N"):
            check_padding_bits(wide, 40)
        # The kernel's own override has no plain counterpart to break.
        with pytest.raises(ValueError, match="_debug_vote_n"):
            bgemm(lhs, rhs[:, :40], thresholds=thr[:40],
                  out_kind="bitpacked", _debug_vote_n=64)
    check_padding_bits(wide, 40)  # off outside debug_checks()


def _block_case(c=32):
    x = torch.ones((2, 8, 8, c))  # all +1 against an all +1 filter: t = 9C
    pf = bitpack(torch.ones((c, 3, 3, c)))
    tr = OutputTransform(multiplier=np.full(c, 0.5, np.float32),
                         bias=np.zeros(c, np.float32), clamp_min=-9 * c,
                         clamp_max=9 * c)
    return x, pf, tr, BConv2DParams(channels_in=c, padding=Padding.SAME,
                                    pad_value=1)


def test_residual_check_passes_and_trips():
    """``|t| <= K``: honest K passes (random and saturated inputs), an
    understated K trips (``test_debug_checks.py``'s case)."""
    x, pf, tr, params = _block_case()
    rng = np.random.default_rng(1)
    xr = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    want = binary_residual_block_plain(xr, pf, tr, params)
    with debug_checks():
        assert torch.equal(binary_residual_block(xr, pf, tr, params), want)
        binary_residual_block(x, pf, tr, params)
        binary_residual_block(x, pf, tr, params, has_residual=False,
                              _debug_k=9 * 32)
        with pytest.raises(RuntimeError, match="one-padding"):
            binary_residual_block(x, pf, tr, params, _debug_k=9 * 32 - 32)


def test_overrides_need_debug_checks():
    """The default build has no checks to trip: an override outside
    ``debug_checks()`` is refused, not ignored."""
    lhs = torch.zeros((2, 1), dtype=torch.int32)
    rhs = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="debug_checks"):
        bgemm(lhs, rhs, out_kind="accum", _debug_total_bits=1)
    x, pf, tr, params = _block_case()
    with pytest.raises(ValueError, match="debug_checks"):
        binary_residual_block(x, pf, tr, params, _debug_k=1)


def test_raise_for_names_every_broken_invariant():
    debug.raise_for(0)
    with pytest.raises(RuntimeError) as e:
        debug.raise_for(1 | 4 | 8)
    text = str(e.value)
    assert "total_bits" in text and "beyond N" in text and "K" in text
    assert "split-K" not in text
    assert sorted(debug.CHECKS) == [1, 2, 4, 8]


def test_debug_flag_gives_a_library_of_its_own(tmp_path, monkeypatch):
    """The debug build's flags are hashed like the default's, so it is a
    library of its own, named apart."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "debug_checks.cuh"\n')
    (csrc / "debug_checks.cuh").write_text("// checks\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    default, checked = _build._target("a")[1], _build._target("a", True)[1]
    assert default != checked
    assert "-debug-" in checked and "-debug-" not in default
    assert _build._flags(True) == _build.NVCC_FLAGS + ["-DCE_DEBUG_CHECKS"]
    assert "-DCE_DEBUG_CHECKS" not in _build.NVCC_FLAGS
    assert _build.headers() == ["debug_checks.cuh"]


def test_debug_checks_selects_the_debug_library_and_restores_the_default(
        monkeypatch):
    loaded = []

    class FakeLib:
        class _Fn:
            argtypes = ()
        ce_bgemm = ce_residual_block = ce_error_string = _Fn()

    def load(name, debug_build=False):
        loaded.append((name, debug_build))
        return FakeLib()

    monkeypatch.setattr(_build, "load", load)
    bgemm_mod._library(debug.enabled())
    with debug_checks():
        assert debug.enabled()
        bgemm_mod._library(debug.enabled())
        residual_mod._library(debug.enabled())
        with pytest.raises(KeyError):
            with debug_checks():
                raise KeyError("inside")
        assert debug.enabled()  # the inner block restored the outer state
    assert not debug.enabled()
    residual_mod._library(debug.enabled())
    assert loaded == [("bgemm", False), ("bgemm", True),
                      ("residual_block", True), ("residual_block", False)]


def test_debug_checks_hold_in_the_thread_that_enters_them():
    seen = []
    with debug_checks():
        t = threading.Thread(target=lambda: seen.append(debug.enabled()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert debug.enabled()
    assert seen == [False]


def test_the_repo_sources_carry_the_checks_behind_the_flag():
    """Both kernels include the checks' header, and every check sits behind
    ``CE_DEBUG_CHECKS``: the default build compiles none of them."""
    import os

    for name in ("bgemm", "residual_block"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert '#include "debug_checks.cuh"' in src
        # every use of the checks' namespace lies in the CE_DEBUG_CHECKS
        # branch of an #ifdef (its #else branch is the default build's)
        stack, outside = [], []
        for line in src.splitlines():
            directive = line.strip()
            if directive.startswith("#if"):
                stack.append("CE_DEBUG_CHECKS" in directive)
            elif directive.startswith("#else"):
                stack[-1] = False
            elif directive.startswith("#endif"):
                stack.pop()
            elif "ce_debug::" in line and not any(stack):
                outside.append(line)
        assert stack == [] and outside == [], (name, outside)
    with open(os.path.join(_build.CSRC, "debug_checks.cuh")) as f:
        header = f.read()
    assert "#ifdef CE_DEBUG_CHECKS" in header and "assert(" not in header
    for bit, _ in debug.CHECKS.items():
        assert f"= {bit}," in header
