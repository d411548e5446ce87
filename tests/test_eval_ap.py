"""The numpy AP / precision / recall against scikit-learn's definitions
(the reference computes them with scikit-learn, which serves here only
as a test oracle where installed)."""

import warnings

import numpy as np
import pytest

from sed_jax.eval.ap import average_precision, sed_average_precision
from sed_jax.eval.calculate_metrics import calculate_precision_recall_f1


def _cases():
    """Random multilabel problems, some with tied scores and a class
    without positives."""
    rng = np.random.RandomState(0)
    for trial in range(12):
        n, c = rng.randint(2, 80), rng.randint(1, 6)
        y = (rng.rand(n, c) < rng.uniform(0.1, 0.6)).astype(np.float32)
        s = rng.rand(n, c).astype(np.float32)
        if trial % 3 == 0:
            s = np.round(s, 1)
        if trial % 4 == 0:
            y[:, 0] = 0.0
        yield y, s


@pytest.mark.parametrize('average', [None, 'macro', 'micro'])
def test_average_precision_matches_sklearn(average):
    metrics = pytest.importorskip('sklearn.metrics')
    for y, s in _cases():
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            want = metrics.average_precision_score(y, s, average=average)
        np.testing.assert_allclose(average_precision(y, s, average),
                                   want, rtol=0, atol=1e-12)


def test_precision_recall_match_sklearn():
    metrics = pytest.importorskip('sklearn.metrics')
    rng = np.random.RandomState(1)
    for y, s in _cases():
        th = rng.rand(y.shape[1])
        pred = (s > th[None, :]).astype(np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            want_p = metrics.precision_score(y.ravel(), pred.ravel())
            want_r = metrics.recall_score(y.ravel(), pred.ravel())
        p, r, f1 = calculate_precision_recall_f1(y, s, th)
        assert p == pytest.approx(want_p, abs=1e-12)
        assert r == pytest.approx(want_r, abs=1e-12)
        assert f1 == pytest.approx(
            2 * p * r / (p + r) if p + r > 0 else 0.0)


def test_sed_average_precision_flattens_time():
    rng = np.random.RandomState(2)
    strong = (rng.rand(3, 20, 4) < 0.3).astype(np.float32)
    framewise = rng.rand(3, 20, 4).astype(np.float32)
    np.testing.assert_array_equal(
        sed_average_precision(strong, framewise),
        average_precision(strong.reshape(60, 4), framewise.reshape(60, 4)))
    # a perfect ranking has AP 1 for every class with positives
    ap = average_precision(strong.reshape(60, 4), strong.reshape(60, 4))
    assert np.all(ap == 1.0)
