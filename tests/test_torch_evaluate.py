"""The port's evaluation harness against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from compute_engine_tpu.runtime import evaluate as jev

from compute_engine_tpu_torch.runtime.evaluate import (_imagenet_dir_batches,
                                                       evaluate,
                                                       imagenet_preprocess,
                                                       main,
                                                       synthetic_batches)

# Bilinear resize with antialiasing, torch's against jax.image.resize, on a
# 0-255 scale: the two sum the taps' weights in another order.
RESIZE_ATOL = 0.01


def test_synthetic_batches_equal_jax():
    kw = dict(num_batches=3, batch=4, size=(8, 8), num_classes=10, seed=5)
    got, want = list(synthetic_batches(**kw)), list(jev.synthetic_batches(**kw))
    assert len(got) == len(want) == 3
    for (x, y), (jx, jy) in zip(got, want):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_evaluate_perfect_and_random():
    num_classes = 10
    rng = np.random.default_rng(0)
    proj = rng.normal(0, 1, (3, num_classes)).astype(np.float32)

    def oracle_fn(x):
        return x.mean(axis=(1, 2)) @ proj

    batches = [(x, np.argmax(oracle_fn(x), axis=-1))
               for x, _ in synthetic_batches(num_batches=3, batch=16,
                                             size=(8, 8),
                                             num_classes=num_classes)]
    res = evaluate(oracle_fn, batches, progress_every=0)
    jres = jev.evaluate(oracle_fn, batches, progress_every=0)
    assert res["images"] == 48
    assert res["top1"] == 1.0 and res["top5"] == 1.0
    assert res.keys() == jres.keys()
    assert all(res[k] == jres[k] for k in res if k != "images_per_sec")
    res_rand = evaluate(lambda x: rng.normal(0, 1, (len(x), num_classes)),
                        batches, progress_every=0)
    assert res_rand["top1"] < 0.5


def test_evaluate_top5_superset_and_tensor_outputs(capsys):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (32, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, 32)
    probs = rng.normal(0, 1, (32, 10)).astype(np.float32)
    res = evaluate(lambda _: probs, [(x, y)] * 2, progress_every=1)
    assert res["top5"] >= res["top1"]
    assert "64 images, top-1 so far" in capsys.readouterr().out
    from_tensor = evaluate(lambda _: torch.from_numpy(probs), [(x, y)] * 2,
                           progress_every=0)
    assert (from_tensor["top1"], from_tensor["top5"]) == (res["top1"],
                                                          res["top5"])
    want = jev.evaluate(lambda _: probs, [(x, y)] * 2, progress_every=0)
    assert (res["top1"], res["top5"]) == (want["top1"], want["top5"])


@pytest.mark.parametrize("shape", [(2, 100, 140, 3), (2, 517, 333, 3),
                                   (1, 256, 256, 3), (1, 300, 256, 3)])
def test_imagenet_preprocess_matches_jax(shape):
    """An upscale, a downscale (antialiased), no resize, one axis only."""
    x = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    got, want = imagenet_preprocess(x), np.asarray(jev.imagenet_preprocess(x))
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    small = imagenet_preprocess(x, size=64)
    np.testing.assert_allclose(small, np.asarray(jev.imagenet_preprocess(
        x, size=64)), atol=RESIZE_ATOL, rtol=0)


def test_directory_loader_matches_jax(tmp_path):
    """Class directories in sorted order give the labels; images of any size
    come out preprocessed. On a few PNGs written here."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    for cls, n in (("n02", 2), ("n01", 3)):
        os.makedirs(tmp_path / cls)
        for i in range(n):
            h, w = rng.integers(40, 90, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                            ).save(tmp_path / cls / f"img{i}.png")
    got = list(_imagenet_dir_batches(str(tmp_path), batch=2, size=32))
    want = list(jev._imagenet_dir_batches(str(tmp_path), batch=2, size=32))
    assert [len(y) for _, y in got] == [2, 2, 1]
    assert np.concatenate([y for _, y in got]).tolist() == [0, 0, 0, 1, 1]
    for (x, y), (jx, jy) in zip(got, want):
        assert x.shape == (len(y), 32, 32, 3)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(x, np.asarray(jx), atol=RESIZE_ATOL)


def test_main_raises_without_a_card_and_runs_on_the_cpu(capsys, monkeypatch):
    import json

    from compute_engine_tpu_torch.models import zoo

    monkeypatch.setitem(zoo.MODELS, "tiny", zoo.tiny_quicknet(num_classes=7))
    monkeypatch.setattr(
        "compute_engine_tpu_torch.runtime.evaluate.synthetic_batches",
        lambda batch, num_classes: synthetic_batches(
            2, batch, size=(32, 32), num_classes=num_classes))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--model", "tiny", "--batch", "4"])
    capsys.readouterr()
    main(["--model", "tiny", "--batch", "4", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["images"] == 8 and 0.0 <= res["top1"] <= res["top5"] <= 1.0
