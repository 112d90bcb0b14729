"""A failing device kernel on the L2 path raises: no silent NumPy result.

The Pre-Scan column sums (identify/prescan._L2Kernels) and the Enet fold
Grams (ops/enet._fold_grams) run on the device, on one device or over
the mesh; each route is made to fail here and the error must surface.
The explicit ``use_device=False`` host path is the only NumPy route."""

import numpy as np
import pytest

from strainscan_tpu.identify import prescan
from strainscan_tpu.ops import enet
from strainscan_tpu.parallel import sharded as psh


class DeviceFailure(RuntimeError):
    pass


def _boom(*args, **kwargs):
    raise DeviceFailure("device kernel failed")


def _x(n=512, s=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, s)) < 0.4).astype(np.int8)


# (module, attribute, min_shard_rows): one device, then the mesh route
# over the 8 virtual CPU devices of the test config
FOLD_ROUTES = [(enet, "_gram_scan", None),
               (psh, "sharded_fold_grams_fn", 1)]
PRESCAN_ROUTES = [(prescan, "_jit_kernels", None),
                  (psh, "sharded_colsum_fn", 1)]


@pytest.mark.parametrize("mod,attr,rows", FOLD_ROUTES,
                         ids=["one_device", "mesh"])
def test_fold_grams_device_failure_raises(monkeypatch, mod, attr, rows):
    X = _x().astype(np.float64)
    y = np.arange(X.shape[0], dtype=np.float64) % 7
    train = np.ones((2, X.shape[0]), dtype=bool)
    monkeypatch.setattr(mod, attr, _boom)
    with pytest.raises(DeviceFailure):
        enet._fold_grams(X, y, train, min_shard_rows=rows)


@pytest.mark.parametrize("mod,attr,rows", PRESCAN_ROUTES,
                         ids=["one_device", "mesh"])
def test_prescan_kernels_device_failure_raises(monkeypatch, mod, attr,
                                               rows):
    monkeypatch.setattr(mod, attr, _boom)
    with pytest.raises(DeviceFailure):
        kern = prescan._L2Kernels(_x(), min_shard_rows=rows)
        kern.colsum(kern.to_mask(np.ones(512, dtype=bool)))


def test_prescan_host_path_matches_device():
    X = _x()
    m = np.arange(X.shape[0]) % 3 == 0
    host = prescan._L2Kernels(X, use_device=False)
    dev = prescan._L2Kernels(X)
    assert host.jax is None and dev.jax is not None
    np.testing.assert_array_equal(host.colsum(host.to_mask(m)),
                                  dev.colsum(dev.to_mask(m)))
