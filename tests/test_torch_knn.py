"""The port's plain kNN tables (the knn_topk kernel's plain version and
the torch-reference engine's path) against the JAX package: the
streaming table functions and the Pallas kernel in interpret mode.  Tolerance
0: indices equal and float32 distances equal bit for bit, ties
included."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import knn as jknn  # noqa: E402
from repro.kernels.knn_topk.ops import knn_topk_streaming  # noqa: E402
from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402

S, E, L = 3, 5, 97


def _lags(seed=0, L=L):
    """(S, E, L) lag-like rows; series 1 has duplicated columns (ties)."""
    x = np.random.default_rng(seed).standard_normal((S, E, L)).astype(np.float32)
    x[1, :, 40:60] = x[1, :, 0:20]
    return x


def _assert_same(t_idx, t_dist, j_idx, j_dist):
    j_idx, j_dist = np.asarray(j_idx), np.asarray(j_dist)
    t_idx, t_dist = t_idx.numpy(), t_dist.numpy()
    assert t_idx.dtype == np.int32 and t_dist.dtype == np.float32
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_dist.view(np.int32), j_dist.view(np.int32))


@pytest.mark.parametrize("tile", [16, 30, 97, 200])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_all_E_streaming_matches_jax_streaming(tile, exclude_self):
    x = _lags()
    ti, td = tknn.knn_tables_all_E_streaming(
        torch.tensor(x), torch.tensor(x), E + 1, exclude_self, tile)
    for s in range(S):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), E + 1, exclude_self, tile)
        _assert_same(ti[s], td[s], ji, jd)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_version_matches_jax_pallas_kernel(exclude_self):
    x = _lags(1)
    # Phase-1 shape: queries and candidates are different halves.
    Vq, Vc = (x, x) if exclude_self else (x[..., 50:], x[..., :50])
    ti, td = knn_topk(torch.tensor(Vq), torch.tensor(Vc), E + 1,
                      exclude_self, range(1, E + 1))
    for s in range(S):
        ji, jd = knn_topk_streaming(
            jnp.asarray(Vq[s]), jnp.asarray(Vc[s]), E + 1,
            exclude_self=exclude_self, block_q=32, tile_c=24, interpret=True)
        _assert_same(ti[s], td[s], ji, jd)


@pytest.mark.parametrize("buckets", [(2,), (1, 3), (2, 4, 5)])
@pytest.mark.parametrize("tile", [13, 97])
def test_bucketed_matches_jax_streaming(buckets, tile):
    x = _lags(2)
    k = buckets[-1] + 1
    ti, td = tknn.knn_tables_bucketed_streaming(
        torch.tensor(x), torch.tensor(x), k, True, buckets, tile)
    ri, rd = knn_topk_ref(torch.tensor(x), torch.tensor(x), k, True, buckets)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    for s in range(S):
        ji, jd = jknn.knn_tables_bucketed_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), k, True, buckets, tile)
        _assert_same(ti[s], td[s], ji, jd)


def test_k_equals_Lc_returns_the_masked_self_as_inf():
    x = _lags(3)[..., :7]
    ti, td = knn_topk(torch.tensor(x), torch.tensor(x), 7, True, range(1, E + 1))
    assert torch.isinf(td[..., -1]).all()
    assert torch.equal(ti[..., -1], torch.arange(7, dtype=torch.int32).expand_as(ti[..., -1]))
    for s in range(S):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), 7, True, 3)
        _assert_same(ti[s], td[s], ji, jd)
        ji, jd = knn_topk_streaming(jnp.asarray(x[s]), jnp.asarray(x[s]), 7,
                                    exclude_self=True, interpret=True)
        _assert_same(ti[s], td[s], ji, jd)


@pytest.mark.parametrize("tile", [8, 50, 300])
def test_all_tied_rows_resolve_to_the_lowest_id(tile):
    """A dead (constant) series and a periodic one whose points repeat
    exactly: every row is full of equal distances."""
    x = np.zeros((2, E, 120), np.float32)
    per = np.sin(np.arange(30, dtype=np.float32))
    for e in range(E):
        x[1, e] = np.tile(np.roll(per, e), 4)
    ti, td = tknn.knn_tables_all_E_streaming(
        torch.tensor(x), torch.tensor(x), E + 1, True, tile)
    assert torch.equal(ti[0, 0, 5], torch.tensor([0, 1, 2, 3, 4, 6], dtype=torch.int32))
    for s in range(2):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), E + 1, True, tile)
        _assert_same(ti[s], td[s], ji, jd)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_dense_oracle_matches_streaming_and_jax_dense(exclude_self):
    x = _lags(4)
    di, dd = tknn.knn_tables_dense(torch.tensor(x), torch.tensor(x), 4, exclude_self)
    for tile in (5, 33):
        si, sd = tknn.knn_tables_all_E_streaming(
            torch.tensor(x), torch.tensor(x), 4, exclude_self, tile)
        assert torch.equal(si, di)
        assert torch.equal(sd.view(torch.int32), dd.view(torch.int32))
    for s in range(S):
        ji, jd = jknn.knn_tables_dense(jnp.asarray(x[s]), jnp.asarray(x[s]), 4,
                                       exclude_self, impl="unroll")
        _assert_same(di[s], dd[s], ji, jd)


@pytest.mark.parametrize("impl", ["scan", "unroll", "blocked:4", "blocked:2",
                                  "blocked:3", "rebuild"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_dense_oracle_impls_match_jax_impls(impl, exclude_self):
    """``knn_tables_dense(impl=)`` against the JAX function's same impl
    (E_max 8: blocked:3 falls back to unroll, as JAX does).  The
    cumulative variants: indices and distances bit-equal, ties included.
    rebuild (the matrix-product form, summed in another order than XLA's):
    distances within float32 round-off of their scale, indices equal
    wherever the table's neighbours are no near-tie."""
    x = np.random.default_rng(9).standard_normal((2, 8, 80)).astype(np.float32)
    x[1, :, 40:55] = x[1, :, 0:15]  # duplicated points: exact ties
    k = 9
    ti, td = tknn.knn_tables_dense(torch.tensor(x), torch.tensor(x), k,
                                   exclude_self, impl=impl)
    for s in range(2):
        if impl != "rebuild":
            ji, jd = jknn.knn_tables_dense(jnp.asarray(x[s]), jnp.asarray(x[s]), k,
                                           exclude_self, impl=impl)
            _assert_same(ti[s], td[s], ji, jd)
            continue
        # one neighbour more, to see a near-tie at the k-th place too
        ji, jd = (np.asarray(a) for a in jknn.knn_tables_dense(
            jnp.asarray(x[s]), jnp.asarray(x[s]), k + 1, exclude_self, impl=impl))
        fin = np.isfinite(jd[..., :k])
        tol = 1e-5 * max(1.0, float(np.abs(jd[np.isfinite(jd)]).max()))
        assert np.array_equal(np.isfinite(td[s].numpy()), fin)
        assert np.abs(td[s].numpy()[fin] - jd[..., :k][fin]).max() <= tol
        # a near-tie: two of a row's k + 1 nearest within tol of each other
        # -- either order is right there
        near = (np.diff(jd, axis=-1) <= tol).any(-1)
        diff = (ti[s].numpy() != ji[..., :k]).any(-1)
        print(f"rebuild, series {s}: {int(near.sum())} rows with near-ties, "
              f"{int((diff & ~near).sum())} other rows differ")
        assert not (diff & ~near).any()


@pytest.mark.parametrize("tile", [7, 40])
def test_bfloat16_accumulator_is_tile_invariant(tile):
    """The bf16 accumulator stays in the plain version.  XLA keeps excess
    precision between bf16 ops, so the JAX tables are no bit reference
    here; the port's own invariant holds: any tile width equals the
    dense oracle, bit for bit."""
    x = torch.tensor(_lags(5))
    di, dd = tknn.knn_tables_dense(x, x, E + 1, True, dist_dtype="bfloat16")
    ti, td = tknn.knn_tables_all_E_streaming(x, x, E + 1, True, tile,
                                             dist_dtype="bfloat16")
    assert torch.equal(ti, di)
    assert torch.equal(td.view(torch.int32), dd.view(torch.int32))
    _, fd = tknn.knn_tables_dense(x, x, E + 1, True)
    assert torch.allclose(td, fd, rtol=2e-2, atol=1e-2)


def test_weights_and_forecast_match_jax():
    x = _lags(6)
    fut = np.random.default_rng(7).standard_normal((S, L)).astype(np.float32)
    ti, td = tknn.knn_tables_all_E_streaming(
        torch.tensor(x), torch.tensor(x), E + 1, True, 40)
    _, tw = tknn.tables_with_weights(ti, td)
    tp = tknn.simplex_forecast(ti, tw, torch.tensor(fut)).numpy()
    bi, bw = tknn.tables_with_weights_bucketed(ti[:, 1:4:2], td[:, 1:4:2], (2, 4))
    for s in range(S):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), E + 1, True, 40)
        _, jw = jknn.tables_with_weights(ji, jd)
        np.testing.assert_allclose(tw[s].numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
        jp = jknn.simplex_forecast(ji, jw, jnp.asarray(fut[s]))
        np.testing.assert_allclose(tp[s], np.asarray(jp), rtol=1e-5, atol=1e-6)
        _, jbw = jknn.tables_with_weights_bucketed(ji[1:4:2], jd[1:4:2], (2, 4))
        np.testing.assert_allclose(bw[s].numpy(), np.asarray(jbw), rtol=1e-6, atol=1e-7)


def test_plain_tables_reject_what_the_reference_rejects():
    x = torch.tensor(_lags())
    with pytest.raises(ValueError, match="exceeds candidate count"):
        knn_topk(x, x, L + 1, False, (1,))
    with pytest.raises(ValueError, match="ascending"):
        knn_topk(x, x, 3, False, (3, 2))
    with pytest.raises(ValueError, match="exceeds lag rows"):
        knn_topk(x, x, 3, False, (E + 1,))
    with pytest.raises(ValueError, match="query set == candidate set"):
        knn_topk(x, x[..., :50], 3, True, (1,))
