"""Library-sharded kNN of the port against the JAX package, bit for bit
(tolerance 0: indices equal, float32 distances equal in their bits):
the column-range table builder at the same ``col_offset`` / ``col_hi``
(masked entries included), ``merge_topk_tree`` and the host oracle
``merge_shard_tables``, and ``knn_tables_library_sharded_sim`` at 1-7
shards against JAX's unsharded streaming table — with and without
``exclude_self``, a last shard narrower than k, k equal to the shard
width, and an all-tied row.  The JAX sharded path never reaches a
Pallas kernel, so JAX runs its jnp builders on the CPU."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import knn as jknn  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402

E = 4


def _lags(L, seed=0, S=2):
    """(S, E, L) lag-like rows; series 1 repeats columns (ties), and its
    column 3 ties with every other column at distance 0 in a dead run."""
    x = np.random.default_rng(seed).standard_normal((S, E, L)).astype(np.float32)
    if S > 1:
        x[1, :, L // 2 : L // 2 + L // 5] = x[1, :, : L // 5]
    return x


def _same(t_idx, t_dist, j_idx, j_dist):
    t_idx = t_idx.numpy() if isinstance(t_idx, torch.Tensor) else t_idx
    t_dist = t_dist.numpy() if isinstance(t_dist, torch.Tensor) else t_dist
    np.testing.assert_array_equal(t_idx, np.asarray(j_idx))
    np.testing.assert_array_equal(np.asarray(t_dist).view(np.int32),
                                  np.asarray(j_dist).view(np.int32))


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("lo,hi,width", [(0, 20, 20), (20, 40, 20), (40, 53, 20),
                                         (60, 53, 20), (13, 30, 25)])
def test_column_range_builder_matches_jax(exclude_self, lo, hi, width):
    """A shard [lo, hi) padded to ``width`` columns: ids global, columns at
    or past hi (the padding, or a shard wholly past Lc = 53) +inf with
    their own ids; the self column of a query masked by its global id."""
    L = 53
    x = _lags(L)
    part = np.zeros((2, E, width), np.float32)
    n = max(0, min(hi, L) - lo)
    part[..., :n] = x[..., lo:lo + n]
    k = min(6, width)
    ti, td = tknn.knn_tables_all_E_streaming(
        torch.tensor(x), torch.tensor(part), k, exclude_self, 8,
        col_offset=lo, col_hi=hi)
    for s in range(2):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(part[s]), k, exclude_self, 8,
            col_offset=lo, col_hi=hi)
        _same(ti[s], td[s], ji, jd)
    if hi <= lo:
        assert torch.isinf(td).all()
        assert (ti >= lo).all()


@pytest.mark.parametrize("exclude_self", [False, True])
def test_plain_kernel_version_with_a_range_matches_the_builder(exclude_self):
    """``knn_topk`` on CPU tensors (the kernel's plain version) and
    ``knn_topk_ref`` with a column range equal the builder, at a bucket
    set; the default range is the unsharded table."""
    x = torch.tensor(_lags(61, 3))
    part = x[..., 30:50].contiguous()
    sel = (1, 3, 4)
    want = tknn._knn_tables_streaming(x, part, 7, exclude_self, 16, sel,
                                      col_offset=30, col_hi=45)
    for got in (knn_topk(x, part, 7, exclude_self, sel, col_offset=30, col_hi=45),
                knn_topk_ref(x, part, 7, exclude_self, sel, tile_c=9,
                             col_offset=30, col_hi=45)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    base = tknn._knn_tables_streaming(x, x, 7, exclude_self, 16, sel)
    got = knn_topk(x, x, 7, exclude_self, sel, col_offset=0, col_hi=61)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    with pytest.raises(ValueError, match="column range"):
        knn_topk(x, part, 7, exclude_self, sel, col_offset=30, col_hi=51)
    if exclude_self:
        with pytest.raises(ValueError, match="query rows"):
            knn_topk(x[..., :40].contiguous(), part, 7, True, sel,
                     col_offset=30, col_hi=45)


def _shards(x, k, exclude_self, S, Lc):
    """The port's per-shard tables of ``x`` (S shards of Lc = x's width)."""
    shard = -(-Lc // S)
    out = []
    for s in range(S):
        lo, hi = s * shard, min((s + 1) * shard, Lc)
        part = np.zeros(x.shape[:-1] + (shard,), np.float32)
        part[..., :max(0, hi - lo)] = x[..., lo:hi]
        out.append(tknn.knn_tables_all_E_streaming(
            torch.tensor(x), torch.tensor(part), min(k, shard), exclude_self, 8,
            col_offset=lo, col_hi=hi))
    return out


@pytest.mark.parametrize("S", [2, 3, 5])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_merge_topk_tree_matches_jax_and_the_host_oracle(S, exclude_self):
    L, k = 40, 9
    x = _lags(L, 5)
    parts = _shards(x, k, exclude_self, S, L)
    ti, td = tknn.merge_topk_tree([p[0] for p in parts], [p[1] for p in parts], k)
    hi_, hd_ = tknn.merge_shard_tables([p[0] for p in parts],
                                       [p[1] for p in parts], k)
    _same(ti, td, hi_, hd_)
    for s in range(2):
        ji, jd = jknn.merge_topk_tree([jnp.asarray(p[0][s].numpy()) for p in parts],
                                      [jnp.asarray(p[1][s].numpy()) for p in parts], k)
        _same(ti[s], td[s], ji, jd)
        oi, od = jknn.merge_shard_tables([p[0][s].numpy() for p in parts],
                                         [p[1][s].numpy() for p in parts], k)
        _same(ti[s], td[s], oi, od)


# (L, k, exclude_self): a last shard narrower than k (L 30 in 4 or 7
# shards), k == the shard width (L 28, S 4, k 7), k == L - 1 with
# exclude_self (padding ids must not reach the table), k == L
CASES = [(30, 6, False), (30, 6, True), (28, 7, True), (28, 7, False),
         (23, 22, True), (23, 23, True), (23, 23, False)]


@pytest.mark.parametrize("S", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("L,k,exclude_self", CASES)
def test_sharded_sim_matches_jax_unsharded(S, L, k, exclude_self):
    x = _lags(L, 11)
    x[0, :, 5] = x[0, :, 9] = x[0, :, 17]  # equal points: ties across shards
    cfg = EDMConfig(E_max=E, knn_tile_c=8)
    ti, td = tpipe.knn_tables_library_sharded_sim(
        torch.tensor(x), torch.tensor(x), k, cfg, exclude_self=exclude_self,
        shards=S)
    jcfg = JaxConfig(E_max=E)
    for s in range(2):
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[s]), jnp.asarray(x[s]), k, exclude_self, 8)
        _same(ti[s], td[s], ji, jd)
        si, sd = jpipe.knn_tables_library_sharded_sim(
            jnp.asarray(x[s]), jnp.asarray(x[s]), k, jcfg,
            exclude_self=exclude_self, shards=S)
        _same(ti[s], td[s], si, sd)
    assert int(ti.max()) < L  # no padding id in any table


@pytest.mark.parametrize("S", [1, 2, 3, 4, 7])
def test_sharded_sim_all_tied_row_matches_jax(S):
    """A constant series: every distance ties at 0; the lowest ids win, in
    order, across every shard boundary."""
    L, k = 26, 9
    x = np.full((1, E, L), 0.25, np.float32)
    cfg = EDMConfig(E_max=E)
    for excl in (False, True):
        ti, td = tpipe.knn_tables_library_sharded_sim(
            torch.tensor(x), torch.tensor(x), k, cfg, exclude_self=excl, shards=S)
        ji, jd = jknn.knn_tables_all_E_streaming(
            jnp.asarray(x[0]), jnp.asarray(x[0]), k, excl, 8)
        _same(ti[0], td[0], ji, jd)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_over_spoofed_devices_equals_the_sim(n):
    """The local-device build (shard s on slot s, merged by the tree)
    equals the simulated build at the same shard count."""
    from repro_torch.runtime.platform import spoof_cpu_devices

    x = torch.tensor(_lags(37, 2))
    cfg = EDMConfig(E_max=E)
    got = tpipe.knn_tables_library_sharded(x, x, 8, cfg, exclude_self=True,
                                           devices=spoof_cpu_devices(n))
    want = tpipe.knn_tables_library_sharded_sim(x, x, 8, cfg, exclude_self=True,
                                                shards=n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="exceeds candidate count"):
        tpipe.knn_tables_library_sharded(x, x, 38, cfg, exclude_self=True,
                                         devices=spoof_cpu_devices(n))
