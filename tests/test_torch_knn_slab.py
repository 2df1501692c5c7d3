"""The port's dense-slab kNN tables (``kernels/knn_slab``) against the JAX
package's slab Pallas kernel of the kNN selection bench
(``benchmarks/run.py::_slab_knn_pallas``, run in interpret mode and loaded
by path, so the bench file is read as it stands).  Tolerance 0: indices
equal and float32 distances equal bit for bit, the masked 3.0e38 entries
and their padding / self ids included."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.kernels.knn_slab.ops import knn_slab  # noqa: E402
from repro_torch.kernels.knn_slab.ref import BIG, knn_slab_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_run", REPO / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lags(E, L, seed, kind="normal"):
    x = np.random.default_rng(seed).standard_normal((E, L)).astype(np.float32)
    if kind == "ties":
        x[:, 40:60] = x[:, 0:20]  # duplicated points: equal distances
    elif kind == "constant":
        x[:] = 0.25  # a dead series: every distance ties at 0
    return x


def _pair(E, Lq, Lc, exclude_self, seed, kind):
    if exclude_self and Lq == Lc:
        x = _lags(E, Lq, seed, kind)
        return x, x
    x = _lags(E, Lq + Lc, seed, kind)
    return x[:, :Lq].copy(), x[:, Lq:].copy()


def _same(a_idx, a_dist, b_idx, b_dist):
    a_idx, a_dist = np.asarray(a_idx), np.asarray(a_dist)
    b_idx, b_dist = np.asarray(b_idx), np.asarray(b_dist)
    np.testing.assert_array_equal(a_idx, b_idx)
    np.testing.assert_array_equal(a_dist.view(np.int32), b_dist.view(np.int32))


@pytest.mark.parametrize("E,Lq,Lc,k,exclude_self,kind", [
    (3, 130, 200, 7, False, "normal"),   # a 128 block and an 8-aligned tail
    (2, 20, 777, 9, True, "normal"),     # ragged Lc; self = column q < Lq
    (3, 130, 130, 7, True, "normal"),    # exclude_self on the square set
    (2, 10, 10, 12, True, "normal"),     # k above the valid candidates
    (3, 90, 90, 8, True, "ties"),        # equal distances: earliest column
    (2, 40, 40, 6, False, "constant"),   # every distance ties at 0
])
def test_slab_ref_equals_jax_slab_kernel(jax_bench, E, Lq, Lc, k, exclude_self,
                                         kind):
    Vq, Vc = _pair(E, Lq, Lc, exclude_self, 0, kind)
    ji, jd = jax_bench._slab_knn_pallas(jnp.asarray(Vq), jnp.asarray(Vc), k,
                                        exclude_self)
    ti, td = knn_slab_ref(torch.as_tensor(Vq), torch.as_tensor(Vc), k,
                          exclude_self)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert ti.shape == (E, Lq, k)
    _same(ti, td, ji, jd)
    # the CPU route of the wrapper is the plain version
    _same(*knn_slab(torch.as_tensor(Vq), torch.as_tensor(Vc), k, exclude_self),
          ti, td)


def test_slab_degenerate_k_returns_big_and_padding_ids():
    """k 12 over 9 valid candidates: the table ends in three 3.0e38 entries
    whose ids are the self column and the first padding columns."""
    Vq, Vc = _pair(2, 10, 10, True, 0, "normal")
    ti, td = knn_slab_ref(torch.as_tensor(Vq), torch.as_tensor(Vc), 12, True)
    for e in range(2):
        for q in range(10):
            assert td[e, q, :9].max() < BIG
            assert td[e, q, 9:].tolist() == [np.float32(BIG)] * 3
            assert ti[e, q, 9:].tolist() == sorted([q, 10, 11])
            assert sorted(ti[e, q, :9].tolist()) == [c for c in range(10) if c != q]


@pytest.mark.parametrize("exclude_self", [False, True])
def test_slab_ref_equals_dense_and_streaming_tables_where_k_fits(exclude_self):
    """Where k <= the valid candidates the slab's tables are the dense
    oracle's and the streaming tables' (no masked entry is selected)."""
    E, L, k = 4, 150, 9
    x = _lags(E, L, 3, "ties")
    V = torch.as_tensor(x)
    Vq, Vc = (V, V) if exclude_self else (V[:, :70].contiguous(),
                                          V[:, 70:].contiguous())
    si, sd = knn_slab_ref(Vq, Vc, k, exclude_self)
    di, dd = tknn.knn_tables_dense(Vq[None], Vc[None], k, exclude_self)
    _same(si, sd, di[0], dd[0])
    for tile in (16, 37, 200):
        ri, rd = tknn.knn_tables_all_E_streaming(Vq[None], Vc[None], k,
                                                 exclude_self, tile)
        _same(si, sd, ri[0], rd[0])


def test_slab_takes_k_up_to_the_padded_width_and_refuses_more():
    V = torch.as_tensor(_lags(2, 40, 1))
    i, d = knn_slab(V, V, 128, True)  # Lc 40 pads to 128: every column
    assert i.shape == (2, 40, 128)
    assert sorted(i[1, 5].tolist()) == list(range(128))
    for bad in (0, 129):
        with pytest.raises(ValueError, match="Lc_pad=128"):
            knn_slab(V, V, bad, True)
        with pytest.raises(ValueError, match="Lc_pad=128"):
            knn_slab_ref(V, V, bad, True)
