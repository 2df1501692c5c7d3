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


# --------------------------------------------- the kernel's selection, modelled
def _keys(vals, cols):
    """The kernel's keys: float bits << 32 | column (values are >= +0 or
    3.0e38, so the unsigned order is (value, column))."""
    return ((vals.astype(np.float32).view(np.uint32).astype(np.uint64)
             << np.uint64(32)) | cols.astype(np.uint64))


def _nth_key(keys, floor, t, colbits):
    """The least K with t keys in [floor, K]: the kernel's bitwise search
    over the 31 value bits, then the column bits."""
    ans = 0
    for b in list(range(62, 31, -1)) + list(range(colbits - 1, -1, -1)):
        trial = np.uint64(ans | ((1 << b) - 1))
        if int(((keys >= np.uint64(floor)) & (keys <= trial)).sum()) < t:
            ans |= 1 << b
    return ans


def _model_slab(Vq, Vc, k, exclude_self, cap):
    """A numpy model of ``csrc/knn_slab.cu``'s selection with a candidate
    buffer of ``cap`` keys.  Per lag: a threshold key tau -- the k-th least
    lag-e key of lag e-1's candidates (k <= 32) or of its k winners, at or
    above the k-th least of all keys since these are k distinct columns,
    tightened by the k-th least key of a
    strided sample of ``cap`` distinct columns at lag 1 and wherever the
    winners' bound passes over 2k keys of the sample or, scaled to the
    row, over a quarter of the buffer --; the keys <= tau filtered and
    sorted, the first k kept
    ("filter"); past ``cap`` candidates, or k > cap, the k least keys in
    chunks of ``cap``, each chunk's last key found by the bitwise search
    ("search").  Returns (idx, dist, counters)."""
    E, Lq = Vq.shape
    Lc = Vc.shape[1]
    Lc_pad = -(-Lc // 128) * 128
    colbits = (Lc_pad - 1).bit_length()
    cols = np.arange(Lc_pad)
    sample = np.arange(cap, dtype=np.int64) * Lc_pad // cap
    big = np.float32(BIG)
    idx = np.empty((E, Lq, k), np.int32)
    dist = np.empty((E, Lq, k), np.float32)
    counts = dict(filter=0, search=0, sample=0)
    for q in range(Lq):
        D = np.zeros(Lc, np.float32)
        prev = None  # the columns that bound the next lag's threshold
        for e in range(E):
            d = np.float32(Vq[e, q]) - Vc[e]
            D = D + np.maximum(d * d, np.float32(0))
            vals = np.full(Lc_pad, big, np.float32)
            vals[:Lc] = D
            if exclude_self and q < Lc:
                vals[q] = big
            keys = _keys(vals, cols)
            tau = np.uint64(2**64 - 1)
            if k <= cap:
                if e > 0:  # the k-th least lag-e key of lag e-1's candidates
                    tau = np.sort(keys[prev])[k - 1]
                if Lc_pad > cap:
                    s = keys[sample]
                    ns = int((s <= tau).sum())
                    if e == 0 or ns > 2 * k or ns * Lc_pad > cap * (cap // 4):
                        tau = min(tau, np.sort(s)[k - 1])
                        counts["sample"] += 1
                # the invariant the filter rests on: no winner lies above tau
                assert np.sort(keys)[k - 1] <= tau
            cand = keys[keys <= tau]
            if k <= cap and cand.size <= cap:
                top = np.sort(cand)[:k]
                counts["filter"] += 1
                # up to 32 neighbours a warp selection also takes the next
                # threshold from all the candidates; else from the winners
                prev = (cand if k <= 32 else top) & np.uint64(0xFFFFFFFF)
            else:
                chunks, floor = [], 0
                while sum(c.size for c in chunks) < k:
                    t = min(cap, k - sum(c.size for c in chunks))
                    last = _nth_key(keys, floor, t, colbits)
                    chunk = np.sort(keys[(keys >= np.uint64(floor))
                                         & (keys <= np.uint64(last))])
                    assert chunk.size == t
                    chunks.append(chunk)
                    floor = last + 1
                top = np.concatenate(chunks)
                counts["search"] += 1
                prev = top & np.uint64(0xFFFFFFFF)
            idx[e, q] = (top & np.uint64(0xFFFFFFFF)).astype(np.int64)
            dist[e, q] = (top >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return idx, dist, counts


@pytest.mark.parametrize("E,Lq,Lc,k,exclude_self,kind,cap,route", [
    (4, 6, 500, 7, False, "normal", 128, "filter"),    # sampled thresholds
    (4, 6, 500, 7, True, "normal", 2048, "filter"),    # the kernel's capacity
    (5, 8, 300, 9, True, "ties", 128, "filter"),       # duplicated points
    (4, 6, 500, 6, False, "constant", 128, "filter"),  # every key ties in value
    (3, 10, 10, 12, True, "normal", 64, "filter"),     # k above the valid candidates
    (4, 6, 500, 7, False, "normal", 64, "both"),       # some lags overflow
    (3, 4, 500, 64, False, "normal", 64, "search"),    # the buffer overflows
    (3, 4, 300, 80, True, "normal", 64, "search"),     # k above the capacity
    (2, 3, 100, 128, True, "ties", 64, "search"),      # k == Lc_pad
])
def test_kernel_selection_model_equals_plain_version(E, Lq, Lc, k, exclude_self,
                                                     kind, cap, route):
    """The design of the kernel's selection, at a small buffer: the
    threshold never drops a winner, and filter-then-sort (or the exact
    search) gives the plain version's tables bit for bit."""
    Vq, Vc = _pair(E, Lq, Lc, exclude_self, 1, kind)
    mi, md, counts = _model_slab(Vq, Vc, k, exclude_self, cap)
    ri, rd = knn_slab_ref(torch.as_tensor(Vq), torch.as_tensor(Vc), k,
                          exclude_self)
    _same(mi, md, ri, rd)
    assert counts["filter"] + counts["search"] == E * Lq
    if route == "both":
        assert counts["filter"] > 0 and counts["search"] > 0, counts
    else:
        assert counts[route] == E * Lq, counts
    if route == "filter" and -(-Lc // 128) * 128 > cap:
        assert counts["sample"] >= Lq  # lag 1 always samples


def test_slab_ab_refuses_to_run_without_a_card(tmp_path):
    """The A/B timing of two kernel designs measures on a card or not at
    all: without one it exits before building or timing anything."""
    from repro_torch.bench import slab_ab

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        slab_ab.main(["--parent-source", str(tmp_path / "knn_slab.cu"),
                      "--out", str(tmp_path / "ab.json")])
    assert not (tmp_path / "ab.json").exists()
