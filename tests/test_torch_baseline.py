"""The port's naive CCM baseline (``core/baseline.py``) and the single-E
table it rebuilds per pair (``core/knn.py::knn_table_single_E``) against
the JAX package, and the naive map against the port's improved
``ccm_matrix`` (the invariant the JAX tests hold: Alg. 1 and Alg. 2 give
the same map).  Tolerances: 1e-5 on rho (sums in another order);
single-E tables bit-equal in the sequential form, and within 1e-4
relative on distances in the matrix-product form (it rounds differently:
|q|^2 + |c|^2 - 2 q.c)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baseline as jbase  # noqa: E402
from repro.core import knn as jknn  # noqa: E402
from repro.core.types import EDMConfig as JConfig  # noqa: E402
from repro_torch.core import baseline as tbase  # noqa: E402
from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.core.ccm import ccm_matrix  # noqa: E402
from repro_torch.core.simplex import simplex_batch  # noqa: E402
from repro_torch.core.types import config_from_jax  # noqa: E402
from repro_torch.data.synthetic import dummy_brain  # noqa: E402

N, L, E_MAX = 6, 120, 4


@pytest.fixture(scope="module")
def data():
    ts = dummy_brain(N, L, seed=2)
    jcfg = JConfig(E_max=E_MAX)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    _, optE = simplex_batch(torch.as_tensor(ts), dataclasses.replace(
        cfg, engine="torch-reference"))
    return ts, optE.numpy(), cfg, jcfg


def test_ccm_pair_naive_matches_jax(data):
    ts, optE, cfg, jcfg = data
    from repro.core.ccm import all_futures as jfut
    from repro_torch.core.ccm import all_futures as tfut

    jf = np.asarray(jfut(jnp.asarray(ts), jcfg))
    tf = tfut(torch.as_tensor(ts), cfg)
    np.testing.assert_array_equal(tf.numpy(), jf)
    for i, j, E in ((0, 1, 1), (2, 3, 2), (5, 4, 4), (3, 3, 3)):
        want = float(jbase.ccm_pair_naive(jnp.asarray(ts[i]), jnp.asarray(jf[j]),
                                          E, jcfg))
        got = float(tbase.ccm_pair_naive(torch.as_tensor(ts[i]), tf[j], E, cfg))
        assert abs(got - want) <= 1e-5, (i, j, E, got, want)


def test_ccm_naive_matches_jax_and_the_improved_map(data):
    ts, optE, cfg, jcfg = data
    got = tbase.ccm_naive(torch.as_tensor(ts), optE, cfg).numpy()
    want = np.asarray(jbase.ccm_naive(jnp.asarray(ts), jnp.asarray(optE), jcfg))
    assert got.shape == (N, N)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    improved = ccm_matrix(torch.as_tensor(ts), optE, dataclasses.replace(
        cfg, engine="torch-reference")).numpy()
    np.testing.assert_allclose(got, improved, atol=1e-5, rtol=0)


@pytest.mark.parametrize("E", [1, 3, 5])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_table_single_E_matches_jax(E, exclude_self, masked):
    rng = np.random.default_rng(E)
    V = rng.standard_normal((5, 60)).astype(np.float32)
    V[:, 30:40] = V[:, 0:10]  # ties
    mask = rng.uniform(size=60) < 0.7 if masked else None
    k = 6
    kw = {} if mask is None else {"candidate_mask": jnp.asarray(mask)}
    tkw = {} if mask is None else {"candidate_mask": torch.as_tensor(mask)}
    ji, jd = jknn.knn_table_single_E(jnp.asarray(V), jnp.asarray(V), E, k,
                                     exclude_self, **kw)
    ti, td = tknn.knn_table_single_E(torch.as_tensor(V), torch.as_tensor(V), E,
                                     k, exclude_self, **tkw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    # the matrix-product form: the same rounding up to its own error
    ji, jd = jknn.knn_table_single_E(jnp.asarray(V), jnp.asarray(V), E, k,
                                     exclude_self, matmul_form=True, **kw)
    ti, td = tknn.knn_table_single_E(torch.as_tensor(V), torch.as_tensor(V), E,
                                     k, exclude_self, matmul_form=True, **tkw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    # and the sequential form's tables, up to that error
    si, sd = tknn.knn_table_single_E(torch.as_tensor(V), torch.as_tensor(V), E,
                                     k, exclude_self, **tkw)
    np.testing.assert_allclose(td.numpy(), sd.numpy(), rtol=1e-4, atol=1e-4)


def test_knn_table_single_E_is_the_cumulative_table_at_E():
    V = torch.as_tensor(np.random.default_rng(9).standard_normal((4, 50))
                        .astype(np.float32))
    di, dd = tknn.knn_tables_dense(V[None], V[None], 5, True)
    for E in range(1, 5):
        si, sd = tknn.knn_table_single_E(V, V, E, 5, True)
        assert torch.equal(si, di[0, E - 1])
        assert torch.equal(sd.view(torch.int32), dd[0, E - 1].view(torch.int32))


@pytest.mark.parametrize("Lq,k,tile,n_sel", [(128, 21, 512, 20), (1430, 13, 256, 4),
                                              (7, 3, 128, 1)])
def test_streaming_bytes_matches_jax(Lq, k, tile, n_sel):
    assert tknn.streaming_bytes(Lq, k, tile, n_sel) == jknn.streaming_bytes(
        Lq, k, tile, n_sel)
    assert tknn.streaming_bytes(Lq, k, tile, n_sel, torch.bfloat16) == \
        jknn.streaming_bytes(Lq, k, tile, n_sel, jnp.bfloat16)
