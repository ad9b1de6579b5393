"""The port's entry points (``__graft_entry_torch__.py``) on ``cpu`` slots,
against ``__graft_entry__.py``'s and the JAX package's forwards.

``dryrun_multichip(8, device="cpu")`` runs as ``tests/test_parallel.py``
runs JAX's at 8; ``entry(device="cpu")`` gives QuickNet's probabilities of
its zeros batch. The tiny dry-run model, on weights JAX initialised and
carried across (``interop.params_from_numpy``), is held against JAX's
``packed_apply`` within ``parity.FLOAT32_MODEL_TOL`` with equal top-1, the
tolerance ``tests/test_torch_parallel.py`` states for the sharded forward;
compiled or eager forwards of the port against each other are
``torch.equal``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry_torch__ as g

from compute_engine_tpu.models import convert_model as jconvert
from compute_engine_tpu.models import init_model as jinit
from compute_engine_tpu.models import packed_apply as japply
from compute_engine_tpu.models.zoo import ModelSpec as JModelSpec
from compute_engine_tpu.models.zoo import _quicknet_forward as jquicknet

from compute_engine_tpu_torch.interop import params_from_numpy
from compute_engine_tpu_torch.models import convert_model, packed_apply

import _torch_parity as parity

CPU = torch.device("cpu")


@pytest.mark.parametrize("n, mesh", [(8, (4, 2)), (4, (2, 2)), (2, (1, 2)),
                                     (1, (1, 1))])
def test_dryrun_multichip_on_cpu_slots(n, mesh):
    """The dry run at JAX's mesh for ``n`` slots: the tiny model's output,
    the three TP modes equal, and a reshard that keeps answering."""
    got = g.dryrun_multichip(n, device="cpu")
    assert got["mesh"] == mesh and got["slots"] == f"cpu x {n}"
    assert got["case"] is None  # cpu slots run eagerly
    assert got["out"].shape == (2 * mesh[0], g.TINY_CLASSES)
    assert got["tp_modes"] == (2 * n, 8, 8, 32 * n)
    assert got["reshards"] >= 1


def _jax_tiny():
    def tiny(b, x):
        return jquicknet(b, x, section_filters=g.TINY_FILTERS,
                         section_blocks=(1, 1), num_classes=g.TINY_CLASSES)

    return JModelSpec("tiny_quicknet_dryrun", tiny,
                      input_size=(g.TINY_SIZE, g.TINY_SIZE),
                      num_classes=g.TINY_CLASSES)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_dryrun_model_against_jax(n):
    """The dry run's sharded step over ``n`` ``cpu`` slots, float32, on
    JAX's seed-0 weights of the same tiny model, against JAX's
    ``packed_apply`` on the same batch."""
    jspec = _jax_tiny()
    jparams = jax.tree.map(np.asarray, jinit(jspec, seed=0,
                                             randomize_bn=True))
    spec = g.tiny_spec()
    layers = convert_model(spec, params_from_numpy(jparams))
    interp, got = g.sharded_step(spec, layers, [CPU] * n,
                                 compute_dtype=torch.float32)
    dp, _ = g.mesh_shape(n)
    x = np.random.default_rng(0).normal(
        0, 1, (2 * dp, g.TINY_SIZE, g.TINY_SIZE, 3)).astype(np.float32)
    want = np.asarray(japply(jspec, jconvert(jspec, jparams), jnp.asarray(x),
                             compute_dtype=jnp.float32))
    parity.assert_outputs_close(got, want, **parity.FLOAT32_MODEL_TOL)


def test_entry_on_the_cpu():
    """QuickNet at 224x224 on a zeros batch of 8: finite probabilities of
    shape (8, 1000), equal to ``packed_apply`` on the same weights."""
    fn, (x,) = g.entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.float32
    assert x.device == CPU and not x.any()
    got = fn(x)
    assert got.shape == (8, 1000) and bool(torch.isfinite(got).all())
    want = packed_apply(fn.spec, fn.layers, x, kernel="auto", device="cpu")
    assert torch.equal(got, want)
    assert torch.allclose(got.sum(-1), torch.ones(8), atol=1e-2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_entry_points_raise_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.dryrun_multichip(2)
