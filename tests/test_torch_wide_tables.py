"""The EDM paths past the kernels' fast path (any k, any E_max, more than
64 library sizes or segments a launch) against the JAX package, on the
CPU, where the wrappers run their plain versions: the main path at
E_max 40 and at k_override 70 and 200, the significance path at E_max 40
with 66 library sizes and at k_override 160, the wrappers' routes by k,
and their splits (selection windows, key-select windows, runs of library
sizes, runs of segments) replayed through the plain versions against one
call.

Tolerances as in tests/test_torch_pipeline.py and
tests/test_torch_significance.py: optE equal, rho within 1e-5, the
prefix tables' indices equal, p-values equal wherever no surrogate's null
rho lies within NEAR_TIE of the observed rho.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import knn as jknn  # noqa: E402
from repro.core.pipeline import run_causal_inference as jax_run  # noqa: E402
from repro.core.types import EDMConfig as JCfg  # noqa: E402
from repro.inference import SignificanceConfig as JSig  # noqa: E402
from repro.inference import run_significance as jax_sig  # noqa: E402
from repro_torch.core import ccm as tccm  # noqa: E402
from repro_torch.core import embedding  # noqa: E402
from repro_torch.core.pipeline import run_causal_inference  # noqa: E402
from repro_torch.core.types import EDMConfig, config_from_jax  # noqa: E402
from repro_torch.inference import run_significance  # noqa: E402
from repro_torch.inference.types import sig_config_from_jax  # noqa: E402
from repro_torch.kernels.ccm_lookup.ops import segment_runs  # noqa: E402
from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref  # noqa: E402
from repro_torch.kernels.knn_topk import ops as kops  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref  # noqa: E402

N, L = 6, 300  # random walks: at E_max 40 their optE reach 39
NEAR_TIE = 1e-6
# 66 library sizes: past the prefix kernel's 64 a launch
SIG_SIZES = tuple(range(41, 41 + 3 * 66, 3))


@pytest.fixture(scope="module")
def walks():
    rng = np.random.default_rng(0)
    return np.cumsum(rng.standard_normal((N, L)), axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_map_e40(walks):
    return jax_run(walks, JCfg(E_max=40))


def _tcfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


# ------------------------------------------------------------ main path
def test_main_path_at_e_max_40_matches_jax(walks, jax_map_e40):
    got = run_causal_inference(walks, EDMConfig(E_max=40), device="cpu")
    np.testing.assert_array_equal(got.optE, np.asarray(jax_map_e40.optE))
    assert np.abs(got.rho - np.asarray(jax_map_e40.rho)).max() <= 1e-5
    assert np.asarray(got.optE).max() > 32  # the windows past lag 32 are used


def test_main_path_at_k_override_70_matches_jax(walks):
    want = jax_run(walks, JCfg(E_max=12, k_override=70))
    got = run_causal_inference(walks, EDMConfig(E_max=12, k_override=70),
                               device="cpu")
    np.testing.assert_array_equal(got.optE, np.asarray(want.optE))
    assert np.abs(got.rho - np.asarray(want.rho)).max() <= 1e-5


@pytest.fixture(scope="module")
def walks_8x460():
    rng = np.random.default_rng(8)
    return np.cumsum(rng.standard_normal((8, 460)), axis=1).astype(np.float32)


def test_main_path_at_k_override_200_matches_jax(walks_8x460):
    """Tables of 200 neighbours (the kernels' key-select route on the card):
    phase 1 over 228 candidates, phase 2 over 456."""
    want = jax_run(walks_8x460, JCfg(E_max=4, k_override=200))
    got = run_causal_inference(walks_8x460, EDMConfig(E_max=4, k_override=200),
                               device="cpu")
    assert kops.route(tuple(range(1, 5)), 200) == "key_select"
    np.testing.assert_array_equal(got.optE, np.asarray(want.optE))
    assert np.abs(got.rho - np.asarray(want.rho)).max() <= 1e-5


# ------------------------------------------------------ significance path
def test_significance_at_e_max_40_with_66_sizes_matches_jax(walks, jax_map_e40):
    """The port's stage at 66 library sizes; JAX's p-values (drawn from the
    full-library null, which no library size touches: JAX's stage at no
    size gives the same keys and nulls) and JAX's tables at every size,
    for the library row of the highest optE."""
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    jcfg = JCfg(E_max=40)
    optE, rho = np.asarray(jax_map_e40.optE), np.asarray(jax_map_e40.rho)
    jsig_cfg = JSig(lib_sizes=SIG_SIZES, n_surrogates=5, alpha=0.5, seed=0,
                    surrogate="shuffle")
    cfg, sig = _tcfg(jcfg), sig_config_from_jax(dataclasses.asdict(jsig_cfg))
    got = run_significance(walks, optE, rho, cfg, sig, device="cpu")
    assert got.drho.shape == got.trend.shape == (N, N)
    assert np.isfinite(got.drho).all()
    want = jax_sig(walks, optE, rho, jcfg, dataclasses.replace(jsig_cfg, lib_sizes=()))

    r = SignificanceChunkRunner(walks, optE, cfg, sig, device="cpu")
    inv = np.argsort(r.order)
    fidx, fw = tccm.ccm_row_tables_bucketed(r.rows(0, r.N), cfg, r.plan)
    seg = tuple(enumerate(r.plan.counts))
    m = sig.n_surrogates
    null = tccm.ccm_row_lookup_bucketed(
        fidx, fw, r.fut_surr, cfg, tuple((b, c * m) for b, c in seg)
    ).numpy().reshape(N, N, m)[:, inv]
    p_tie = (np.abs(null - rho[..., None]) <= NEAR_TIE).any(-1)
    assert p_tie.sum() <= p_tie.size // 4
    np.testing.assert_array_equal(got.pvals[~p_tie], np.asarray(want.pvals)[~p_tie])

    buckets = r.plan.buckets
    assert buckets[-1] > 32
    k = buckets[-1] + 1
    Lp = cfg.n_points(L)
    row = int(np.argmax(optE))
    V = embedding.lag_matrix(torch.tensor(walks[row : row + 1]), 40, 1, Lp)
    ti, td = knn_topk_prefix_ref(V, V, k, True, buckets, SIG_SIZES, col_ids=r.col_ids)
    # JAX's single-E oracle over each nested library (the columns
    # col_ids[:Ls], the others masked): the same sequential lag sums, and
    # random-walk distances do not tie, so the sweep's arrival rule and
    # top_k's lowest-id rule pick the same neighbours
    Vj = jnp.asarray(V[0].numpy())
    cols = r.col_ids.numpy()
    for bi, E in enumerate(buckets):
        table = jax.jit(lambda mask, E=E: jknn.knn_table_single_E(
            Vj, Vj, E, k, True, candidate_mask=mask))
        for si in (0, 63, 64, 65):  # each run's first and last size
            Ls = SIG_SIZES[si]
            ji, jd = table(jnp.asarray(np.isin(np.arange(Lp), cols[:Ls])))
            np.testing.assert_array_equal(ti[0, si, bi].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(td[0, si, bi].numpy(), np.asarray(jd))


def test_significance_at_k_override_160_matches_jax(walks_8x460):
    """The stage with tables of 160 neighbours at library sizes 170, 300 and
    456: drho within 1e-5, trends and p-values equal away from near-ties
    (a null rho within NEAR_TIE of the observed one)."""
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    jcfg = JCfg(E_max=4, k_override=160)
    jmap = jax_run(walks_8x460, jcfg)
    optE, rho = np.asarray(jmap.optE), np.asarray(jmap.rho)
    jsig_cfg = JSig(lib_sizes=(170, 300, 456), n_surrogates=7, alpha=0.5, seed=0,
                    surrogate="shuffle")
    cfg, sig = _tcfg(jcfg), sig_config_from_jax(dataclasses.asdict(jsig_cfg))
    want = jax_sig(walks_8x460, optE, rho, jcfg, jsig_cfg)
    got = run_significance(walks_8x460, optE, rho, cfg, sig, device="cpu")
    assert np.abs(got.drho - np.asarray(want.drho)).max() <= 1e-5

    r = SignificanceChunkRunner(walks_8x460, optE, cfg, sig, device="cpu")
    assert tccm._bucket_k(cfg, r.plan) == 160
    inv = np.argsort(r.order)
    fidx, fw = tccm.ccm_row_tables_bucketed(r.rows(0, r.N), cfg, r.plan)
    seg = tuple(enumerate(r.plan.counts))
    m = sig.n_surrogates
    null = tccm.ccm_row_lookup_bucketed(
        fidx, fw, r.fut_surr, cfg, tuple((b, c * m) for b, c in seg)
    ).numpy().reshape(r.N, r.N, m)[:, inv]
    p_tie = (np.abs(null - rho[..., None]) <= NEAR_TIE).any(-1)
    assert p_tie.sum() <= p_tie.size // 4
    np.testing.assert_array_equal(got.pvals[~p_tie], np.asarray(want.pvals)[~p_tie])
    np.testing.assert_array_equal(got.trend, np.asarray(want.trend))


# ---------------------------------------------------- the wrappers' splits
@pytest.mark.parametrize("k,E_hi,n_runs,want", [
    (21, 20, 1, "fast"), (32, 32, 1, "fast"), (21, 20, 2, "wide"),
    (33, 20, 1, "wide"), (21, 33, 1, "wide"), (128, 40, 1, "wide"),
    (129, 4, 1, "key_select"), (200, 20, 1, "key_select"),
    (715, 40, 3, "key_select"),
])
def test_route_by_k(k, E_hi, n_runs, want):
    """The route of a call, picked once in Python: the fast path at k and
    E_hi up to 32 (one run of sizes), the wide route up to k 128, the
    key-select route past it at any E."""
    assert kops.route(tuple(range(1, E_hi + 1)), k, n_runs) == want
    assert kops.WIDE_K == 128 and kops.ROUTES == ("fast", "wide", "key_select")


def test_ks_mask_words_and_windows(monkeypatch):
    words = kops.ks_mask_words((1, 33, 2048), 0)
    assert len(words) == kops.KS_SPAN // 32 == 64
    assert (words[0], words[1], words[63]) == (1, 1, 1 << 31)
    assert sum(bin(w).count("1") for w in words) == 3
    assert list(kops.ks_mask_words((2049,), 2048))[0] == 1
    for sel, e_lo in (((2049,), 0), ((1,), 2048)):
        with pytest.raises(ValueError, match="key-select launch"):
            kops.ks_mask_words(sel, e_lo)
    assert kops.ks_windows((1, 5, 2048, 2049, 5000)) == [
        (0, (1, 5, 2048)), (2048, (2049,)), (4096, (5000,))]
    monkeypatch.setattr(kops, "KS_SPAN", 8)
    assert kops.ks_windows((1, 8, 9, 20)) == [(0, (1, 8)), (8, (9,)), (16, (20,))]


@pytest.mark.parametrize("k,select_Es", [(150, (1, 5, 9, 17, 20)),
                                         (209, tuple(range(1, 21)))])
def test_knn_topk_key_select_windows_replayed_equal_one_call(monkeypatch, k,
                                                             select_Es):
    """The key-select route's windows (KS_SPAN cut to 8 lags, so that one
    selection takes several launches), each written into its rows, equal
    one call, bit for bit, with a column range, at k below and above the
    candidates that are not masked."""
    monkeypatch.setattr(kops, "KS_SPAN", 8)
    rng = np.random.default_rng(k)
    V = torch.tensor(rng.standard_normal((2, 20, 230)).astype(np.float32))
    Vc = V[..., 20:].contiguous()
    kw = dict(col_offset=20, col_hi=225)
    want_i, want_d = knn_topk_ref(V, Vc, k, True, select_Es, **kw)
    got_i, got_d = torch.empty_like(want_i), torch.empty_like(want_d)
    si0 = 0
    wins = kops.ks_windows(select_Es)
    assert len(wins) > 1
    for e_lo, Es in wins:
        assert Es[0] > e_lo and Es[-1] <= e_lo + 8
        i, d = knn_topk_ref(V, Vc, k, True, Es, **kw)
        got_i[:, si0 : si0 + len(Es)], got_d[:, si0 : si0 + len(Es)] = i, d
        si0 += len(Es)
    assert si0 == len(select_Es)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    # past the 204 candidates of a row below col_hi (the self masked), the
    # masked columns come last, as +inf
    assert torch.isinf(want_d[..., -1]).any() == (k > 204)


def test_prefix_key_select_runs_replayed_equal_one_call():
    """Runs of at most 64 library sizes at k 150 (the key-select route:
    every selected E in one launch a run) equal one call at 66 sizes."""
    rng = np.random.default_rng(5)
    Lp = 230
    V = torch.tensor(rng.standard_normal((1, 8, Lp)).astype(np.float32))
    col_ids = torch.tensor(rng.permutation(Lp).astype(np.int32))
    sizes = tuple(range(151, 151 + 66))
    buckets, k = (2, 5, 8), 150
    want_i, want_d = knn_topk_prefix_ref(V, V, k, True, buckets, sizes, col_ids=col_ids)
    got_i, got_d = torch.empty_like(want_i), torch.empty_like(want_d)
    runs = kops.size_runs(sizes, 64)
    assert kops.route(buckets, k, len(runs)) == "key_select"
    assert kops.ks_windows(buckets) == [(0, buckets)]
    for s0, run in runs:
        i, d = knn_topk_prefix_ref(V, V, k, True, buckets, run, col_ids=col_ids)
        got_i[:, s0 : s0 + len(run)], got_d[:, s0 : s0 + len(run)] = i, d
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


def test_select_mask_refuses_a_mask_past_32_bits():
    assert kops.select_mask((1, 32)) == (1 << 31) | 1
    assert kops.select_mask((35, 40), e_lo=8) == (1 << 26) | (1 << 31)
    for sel, e_lo in (((33,), 0), ((1, 40), 0), ((8,), 8), ((41,), 8)):
        with pytest.raises(ValueError, match="selection mask"):
            kops.select_mask(sel, e_lo)


@pytest.mark.parametrize("select_Es,k,lists,want", [
    ((3, 5, 8, 12), 13, 24, [(0, (3, 5, 8, 12))]),          # the fast path
    (tuple(range(1, 33)), 32, 24, [(0, tuple(range(1, 33)))]),
    ((1, 40), 21, 24, [(0, (1,)), (8, (40,))]),
    (tuple(range(1, 21)), 48, 12, [(0, tuple(range(1, 13))), (0, tuple(range(13, 21)))]),
    ((5, 30, 36, 37, 70), 41, 12, [(4, (5, 30, 36)), (5, (37,)), (38, (70,))]),
])
def test_windows_split_the_selection(select_Es, k, lists, want):
    got = kops.windows(select_Es, lists, kops.fast_path(select_Es, k))
    assert got == want
    assert tuple(e for _, Es in got for e in Es) == tuple(select_Es)
    for e_lo, Es in got:
        assert len(Es) <= max(lists, 32) and kops.select_mask(Es, e_lo) < 2 ** 32


@pytest.mark.parametrize("k,select_Es", [
    (70, (1, 5, 12)),
    (41, tuple(range(1, 41))),
    (9, (2, 33, 34, 40)),
])
def test_knn_topk_windows_replayed_equal_one_call(k, select_Es):
    """Each window's tables (the plain version at its E) written into its
    rows, as the wrapper's launches write them, equal one call over the
    whole selection, bit for bit."""
    rng = np.random.default_rng(k)
    V = torch.tensor(rng.standard_normal((2, 40, 90)).astype(np.float32))
    want_i, want_d = knn_topk_ref(V, V, k, True, select_Es)
    got_i, got_d = torch.empty_like(want_i), torch.empty_like(want_d)
    si0 = 0
    lists = 24 if k <= 32 else (12 if k <= 64 else 8)
    for _, Es in kops.windows(select_Es, lists, kops.fast_path(select_Es, k)):
        i, d = knn_topk_ref(V, V, k, True, Es)
        got_i[:, si0 : si0 + len(Es)], got_d[:, si0 : si0 + len(Es)] = i, d
        si0 += len(Es)
    assert si0 == len(select_Es)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


def test_prefix_size_runs_replayed_equal_one_call():
    """Runs of at most 64 library sizes x selection windows, each written
    into its size and E rows, equal one call at all 66 sizes and every E."""
    rng = np.random.default_rng(3)
    Lp = 110
    V = torch.tensor(rng.standard_normal((1, 40, Lp)).astype(np.float32))
    col_ids = torch.tensor(rng.permutation(Lp).astype(np.int32))
    sizes = tuple(range(41, 41 + 66))
    buckets, k = (2, 9, 33, 39), 40
    want_i, want_d = knn_topk_prefix_ref(V, V, k, True, buckets, sizes, col_ids=col_ids)
    got_i, got_d = torch.empty_like(want_i), torch.empty_like(want_d)
    runs = kops.size_runs(sizes, 64)
    assert [len(run) for _, run in runs] == [64, 2]
    for s0, run in runs:
        si0 = 0
        for _, Es in kops.windows(buckets, 12, kops.fast_path(buckets, k, len(runs))):
            i, d = knn_topk_prefix_ref(V, V, k, True, Es, run, col_ids=col_ids)
            got_i[:, s0 : s0 + len(run), si0 : si0 + len(Es)] = i
            got_d[:, s0 : s0 + len(run), si0 : si0 + len(Es)] = d
            si0 += len(Es)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


def _wide_lists(k):  # knn_topk_prefix_lists(k) of the C source
    return {1: 24, 2: 12, 3: 8, 4: 6}[(k + 31) // 32]


@pytest.mark.parametrize("k,E_max,n_sizes", [
    (21, 30, 70),   # 30 buckets, k <= 32: the wide route at R 1, two windows
    (21, 30, 64),   # one run: the fast path
    (21, 20, 65),
    (41, 40, 70),
    (128, 12, 130),
])
def test_prefix_launch_plan_fits_the_kernels(k, E_max, n_sizes):
    """Every launch the prefix wrapper plans fits the route it names: a
    fast launch writes the whole output (one run of sizes, one window
    from lag 0, E and k at most 32); a wide launch holds at most
    knn_topk_prefix_lists(k) selected E spanning at most 32 lags."""
    buckets = tuple(range(1, E_max + 1))
    sizes = tuple(range(200, 200 + n_sizes))
    runs = kops.size_runs(sizes, 64)
    fast = kops.fast_path(buckets, k, len(runs))
    assert fast == (k <= 32 and E_max <= 32 and n_sizes <= 64)
    wins = kops.windows(buckets, _wide_lists(k), fast)
    assert tuple(e for _, Es in wins for e in Es) == buckets
    for e_lo, Es in wins:
        mask = kops.select_mask(Es, e_lo)
        if fast:
            assert wins == [(0, buckets)] and len(runs) == 1 and mask < 2 ** 32
        else:
            assert len(Es) <= _wide_lists(k) and Es[-1] - e_lo <= kops.SPAN


def test_lookup_segment_runs_replayed_equal_one_call():
    """Runs of at most 64 segments (empty ones included), each over its own
    targets' rows, equal one call over all 150 segments."""
    rng = np.random.default_rng(4)
    S, nb, Lq, k, Lp = 2, 3, 50, 70, 120
    counts = rng.integers(0, 4, 150)
    counts[64:128] = 0  # a run with no target: no launch
    segs = tuple((i % nb, int(c)) for i, c in enumerate(counts))
    B = int(counts.sum())
    idx = torch.tensor(rng.integers(0, Lp, (S, nb, Lq, k)).astype(np.int32))
    w = torch.tensor(rng.uniform(0, 1, (S, nb, Lq, k)).astype(np.float32))
    Y = torch.tensor(rng.standard_normal((B, Lp)).astype(np.float32))
    want = ccm_lookup_ref(idx, w, Y, segs)
    got = torch.full_like(want, float("nan"))
    runs = segment_runs(segs, 64)
    assert len(runs) == 2 and sum(n for _, n, _ in runs) == B
    for b0, n, part in runs:
        got[:, b0 : b0 + n] = ccm_lookup_ref(idx, w, Y[b0 : b0 + n], part)
    assert torch.equal(got, want)
