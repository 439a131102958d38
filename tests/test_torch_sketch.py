"""The port's streaming quantile sketch (``obs/sketch.py``) against the JAX
package's.

The same values, fed in the same order, give the same serialized document
(``to_dict``, compared as JSON) and the same quantiles, exactly: both are
the same float arithmetic. A document written by either package loads
into the other, and merges there to the single-stream sketch of the
union; that is what lets a fleet front merge replica sketches whichever
package each replica runs.
"""
import json
import math

import numpy as np
import pytest

from flexflow_tpu.obs.sketch import QuantileSketch as JSketch
from flexflow_tpu_torch.obs.sketch import QuantileSketch as TSketch

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def _values(kind: str, n: int = 3000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(-4.0, 1.0, n)
    if kind == "uniform":
        return rng.uniform(1e-4, 2.0, n)
    if kind == "with_zeros":
        v = rng.exponential(0.01, n)
        v[::7] = 0.0
        return v
    return np.concatenate([rng.lognormal(-6, 0.3, n // 2),
                           rng.lognormal(1, 0.3, n // 2)])  # bimodal


def _fill(cls, values, **kw):
    sk = cls(**kw)
    for v in values:
        sk.add(float(v))
    return sk


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "with_zeros",
                                  "bimodal"])
@pytest.mark.parametrize("kw", [{}, {"alpha": 0.05},
                                {"max_bins": 16}])
def test_same_values_same_document_and_quantiles(kind, kw):
    vals = _values(kind)
    j, t = _fill(JSketch, vals, **kw), _fill(TSketch, vals, **kw)
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
    assert t.quantiles(QS) == j.quantiles(QS)
    assert t.count == j.count and t.mean == j.mean


@pytest.mark.parametrize("src,dst", [(JSketch, TSketch),
                                     (TSketch, JSketch)])
def test_documents_merge_across_packages(src, dst):
    a, b = _values("lognormal", seed=1), _values("bimodal", seed=2)
    # one replica's sketch serialized by one package, merged by the other
    remote = src.from_dict(json.loads(json.dumps(
        _fill(src, a).to_dict())))
    local = _fill(dst, b)
    local.merge(dst.from_dict(remote.to_dict()))
    union = _fill(dst, np.concatenate([b, a]))
    assert local.to_dict()["bins"] == union.to_dict()["bins"]
    assert local.count == union.count
    assert local.quantiles(QS) == union.quantiles(QS)
    assert math.isclose(local.total, union.total, rel_tol=1e-12)


def test_empty_document_and_edge_behaviour_match():
    j, t = JSketch(), TSketch()
    assert t.to_dict() == j.to_dict()
    assert math.isnan(t.quantile(0.5)) and math.isnan(j.quantile(0.5))
    for sk in (j, t):
        sk.add(float("nan"))         # dropped, as in the reference
        assert sk.count == 0
        with pytest.raises(ValueError):
            sk.quantile(1.5)
        with pytest.raises(ValueError):
            sk.merge(type(sk)(alpha=0.02))
    j2 = JSketch.from_dict(t.to_dict())
    assert j2.to_dict() == t.to_dict()
