"""The port's prefix-snapshot kNN tables (the convergence diagnostic's)
against the JAX package: the plain version equals the JAX one-sweep
builder and the Pallas prefix kernel in interpret mode, bit for bit in
idx and float32 dist, ties included."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import knn as jknn  # noqa: E402
from repro.kernels.knn_topk import ops as jops  # noqa: E402
from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.engine import get_engine  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk_prefix  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref  # noqa: E402

E, L = 6, 120
BUCKETS, LIB_SIZES, K = (1, 3, 6), (25, 60, 120), 7


@pytest.fixture(scope="module")
def lags():
    """(2, E, L) lag matrices; series 0 repeats its first 30 points at
    60..89, so equal distances occur and the tie rule decides."""
    rng = np.random.default_rng(0)
    V = rng.standard_normal((2, E, L)).astype(np.float32)
    V[0, :, 60:90] = V[0, :, 0:30]
    perm = rng.permutation(L).astype(np.int32)
    return V, perm


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_streaming_batch(V, k, excl, buckets, lib_sizes, tile_c, col_ids):
    return jax.vmap(lambda v: jknn.knn_tables_prefix_streaming(
        v, v, k, excl, buckets, lib_sizes, tile_c, col_ids=col_ids))(V)


def _jax_streaming(V, k, excl, buckets, lib_sizes, tile_c, col_ids):
    i, d = _jax_streaming_batch(
        jnp.asarray(V), k, excl, buckets, lib_sizes, tile_c,
        None if col_ids is None else jnp.asarray(col_ids))
    return np.asarray(i), np.asarray(d)


def _port(V, k, excl, buckets, lib_sizes, tile_c, col_ids):
    i, d = knn_topk_prefix_ref(
        torch.tensor(V), torch.tensor(V), k, excl, buckets, lib_sizes,
        col_ids=None if col_ids is None else torch.tensor(col_ids),
        tile_c=tile_c,
    )
    return i.numpy(), d.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))


@pytest.mark.parametrize("tile_c", [13, 64])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_prefix_tables_equal_jax_streaming(lags, tile_c, permuted, exclude_self):
    """Dividing (64: one tile per library-size segment) and non-dividing
    (13) port tile widths against the JAX builder at width 64 (its own
    widths agree with each other: tests/test_inference.py)."""
    V, perm = lags
    col_ids = perm if permuted else None
    got = _port(V, K, exclude_self, BUCKETS, LIB_SIZES, tile_c, col_ids)
    assert got[0].shape == (2, 3, 3, L, K)
    _assert_same(got, _jax_streaming(V, K, exclude_self, BUCKETS, LIB_SIZES,
                                     64, col_ids))


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_prefix_tables_equal_pallas_prefix_kernel(lags, permuted, exclude_self):
    """The Pallas prefix kernel in interpret mode, per series."""
    V, perm = lags
    col_ids = perm if permuted else None
    got = _port(V, K, exclude_self, BUCKETS, LIB_SIZES, None, col_ids)
    cj = None if col_ids is None else jnp.asarray(col_ids)
    i, d = jax.vmap(lambda v: jops.knn_topk_prefix(
        v, v, K, exclude_self, BUCKETS, LIB_SIZES, block_q=128, tile_c=40,
        interpret=True, col_ids=cj))(jnp.asarray(V))
    _assert_same(got, (np.asarray(i), np.asarray(d)))


def test_permuted_ties_go_to_the_earliest_sweep_position(lags):
    """With the repeated points and a permuted sweep, some equal-distance
    neighbours come out in sweep order and not in id order — the rule
    differs from the main path's lowest id, and the tables above pin it."""
    V, perm = lags
    idx, dist = _port(V, K, True, BUCKETS, LIB_SIZES, 13, perm)
    tie = dist[..., 1:] == dist[..., :-1]
    assert tie.any()
    assert (tie & (idx[..., 1:] < idx[..., :-1])).any()
    pos = np.argsort(perm)  # sweep position of each id
    assert not (tie & (pos[idx[..., 1:]] < pos[idx[..., :-1]])).any()


def test_one_sweep_equals_per_size_rebuild_and_engines_agree(lags):
    V, perm = lags
    Vt, ct = torch.tensor(V), torch.tensor(perm)
    want = tknn.knn_tables_prefix_rebuild(Vt, Vt, K, True, BUCKETS, LIB_SIZES,
                                          13, col_ids=ct)
    cfg = EDMConfig(E_max=E, knn_tile_c=13)
    for name in ("torch-reference", "cuda"):  # cuda: CPU tensors -> plain
        got = get_engine(name).knn_tables_prefix(
            Vt, Vt, K, buckets=BUCKETS, lib_sizes=LIB_SIZES, exclude_self=True,
            cfg=cfg, col_ids=ct)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = knn_topk_prefix(Vt, Vt, K, True, BUCKETS, LIB_SIZES, col_ids=ct)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_full_size_slice_equals_bucketed_main_path_tables(lags):
    """Natural order, largest prefix = the whole library: the main path's
    bucketed tables (lowest id == earliest position here)."""
    V, _ = lags
    Vt = torch.tensor(V)
    idx, dist = knn_topk_prefix_ref(Vt, Vt, K, True, BUCKETS, LIB_SIZES)
    bi, bd = tknn.knn_tables_bucketed_streaming(Vt, Vt, K, True, BUCKETS, 32)
    assert torch.equal(idx[:, -1], bi) and torch.equal(dist[:, -1], bd)


@pytest.mark.parametrize("kw", [
    dict(buckets=(3, 1)),
    dict(buckets=(7,)),
    dict(lib_sizes=(60, 25)),
    dict(lib_sizes=(25, 121)),
    dict(lib_sizes=(7, 60)),
    dict(k=3, lib_sizes=(3, 60)),
    dict(Lq=100),
])
def test_prefix_validation_errors_match_jax(lags, kw):
    V, _ = lags
    a = dict(k=K, buckets=BUCKETS, lib_sizes=LIB_SIZES, Lq=L)
    a.update(kw)
    excl = True
    Vq = V[0][:, : a["Lq"]]
    with pytest.raises(ValueError) as jerr:
        jknn.knn_tables_prefix_streaming(
            jnp.asarray(Vq), jnp.asarray(V[0]), a["k"], excl, a["buckets"],
            a["lib_sizes"], 16)
    with pytest.raises(ValueError) as terr:
        knn_topk_prefix_ref(torch.tensor(Vq[None]), torch.tensor(V[:1]), a["k"],
                            excl, a["buckets"], a["lib_sizes"])
    assert str(terr.value) == str(jerr.value)
