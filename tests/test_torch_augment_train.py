"""The port's train-time augmentations against the JAX package's.

* Each colour op at each magnitude on one seeded image: bit for bit with
  the JAX `apply_color_op` (Pillow's ImageOps / ImageEnhance).
* translate, rotate and shear: the same matrix (to 1e-12) and boxes; the
  image within one grey level of `cv2.warpAffine` (cv2 5 interpolates in
  single precision; about 3e-5 of the values differ by one).
* weak / sup / strong pipelines from one seed: the same matrix, boxes,
  labels and scale factor, and the same generator state afterwards (every
  draw in the same order). Pixels are not compared there: the resize
  (cv2's INTER_LINEAR against `interpolate`) differs by one grey level,
  which a later colour op may stretch.
"""
import numpy as np
import pytest

from semi_detr_tpu.data import augment as J
from semi_detr_tpu_torch.data import augment as T

BOXES = [[3.0, 4.0, 30.0, 22.0], [20.0, 10.0, 52.0, 40.0],
         [0.0, 0.0, 8.0, 6.0]]
LABELS = [0, 2, 1]
SCALES = ((40, 60), (48, 72), (56, 80))


class _Draws:
    """A generator stand-in that returns (op, magnitude) to apply_color_op."""

    def __init__(self, op, mag):
        self.values = [op, mag]

    def integers(self, *args):
        return self.values.pop(0)


def _image(seed, h=45, w=61):
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    # a narrow range (autocontrast and equalize have work to do) and noise
    img = 60 + (xs + 2 * ys)[..., None] // 3 + rs.randint(0, 50, (h, w, 3))
    return img.astype(np.uint8)


def _pair(img):
    return J.make_sample(img, BOXES, LABELS), T.make_sample(img, BOXES,
                                                            LABELS)


@pytest.mark.parametrize("mag", range(1, 10))
@pytest.mark.parametrize("op", range(9))
def test_colour_op_bit_exact(op, mag):
    js, ts = _pair(_image(op))
    ref = J.apply_color_op(_Draws(op, mag), js).img
    got = T.apply_color_op(_Draws(op, mag), ts).img
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("op", ["translate_x", "translate_y", "rotate",
                                "shear"])
def test_geometric_op(op, seed):
    fn, kw = {"translate_x": (J.translate, {"x_range": (-0.1, 0.1)}),
              "translate_y": (J.translate, {"y_range": (-0.1, 0.1)}),
              "rotate": (J.rotate, {}), "shear": (J.shear, {})}[op]
    port_fn = getattr(T, fn.__name__)
    js, ts = _pair(_image(10 + seed))
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    ref, got = fn(jr, js, **kw), port_fn(tr, ts, **kw)
    np.testing.assert_allclose(got.matrix, ref.matrix, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.boxes, ref.boxes, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.labels, ref.labels)
    diff = np.abs(got.img.astype(int) - ref.img.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert jr.bit_generator.state == tr.bit_generator.state


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pipeline", ["weak_augment", "sup_augment",
                                      "strong_augment"])
def test_pipelines_same_draws(pipeline, seed):
    js, ts = _pair(_image(20 + seed, 64, 90))
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = getattr(J, pipeline)(jr, js, SCALES)
    got = getattr(T, pipeline)(tr, ts, SCALES)
    assert got.img.shape == ref.img.shape
    np.testing.assert_allclose(got.matrix, ref.matrix, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.boxes, ref.boxes, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.scale_factor, ref.scale_factor)
    assert jr.bit_generator.state == tr.bit_generator.state
    if pipeline == "weak_augment":      # resize and flip only
        diff = np.abs(got.img.astype(int) - ref.img.astype(int))
        assert diff.max() <= 1


def test_rand_erase_and_normalize():
    img = _image(3)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    ref = J.rand_erase(jr, J.make_sample(img))
    got = T.rand_erase(tr, T.make_sample(img))
    np.testing.assert_array_equal(got.img, ref.img)
    assert (got.img == T.FILL).any()
    np.testing.assert_array_equal(T.normalize_image(img),
                                  J.normalize_image(img))
