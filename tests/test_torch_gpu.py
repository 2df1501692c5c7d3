"""Each CUDA kernel of the port against its plain version on the card.

Marked ``gpu``; run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Without a card every test here skips from inside its body (never at
collection, so every pytest worker collects the same tests)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

pytestmark = pytest.mark.gpu


def _card():
    from repro_torch.kernels import kernels_available

    if not kernels_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _lags(S, E, L, seed):
    x = np.random.default_rng(seed).standard_normal((S, E, L)).astype(np.float32)
    if L >= 150:
        x[0, :, 100:150] = x[0, :, :50]  # duplicated points -> ties
    x[-1] = 0.25  # a dead series: every distance ties at 0
    return x


@pytest.mark.parametrize("exclude_self,select_Es,k", [
    (False, tuple(range(1, 21)), 21),
    (True, (3, 5, 8, 12), 13),
    (True, tuple(range(1, 21)), 21),
])
def test_knn_topk_kernel_equals_plain_version(exclude_self, select_Es, k):
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    x = torch.tensor(_lags(4, 20, 400, 0), device=dev)
    Vq, Vc = (x, x) if exclude_self else (x[..., 200:].contiguous(), x[..., :200].contiguous())
    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es)
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


@pytest.mark.parametrize("S,Lq,Lc,k,exclude_self,select_Es", [
    (3, 20, 20, 7, True, tuple(range(1, 21))),     # Lc below the warp width
    (3, 20, 20, 20, True, (2, 9)),                 # ... and k == Lc
    (3, 190, 77, 9, False, tuple(range(1, 21))),   # Lc not a multiple of 32
    (2, 400, 400, 32, True, (4, 11, 20)),          # k at the warp width
    (2, 32, 32, 32, True, tuple(range(1, 21))),    # k == Lc == 32
    (4, 400, 400, 21, True, (20,)),                # one list at E_hi 20
    (4, 400, 400, 2, True, (1,)),                  # a lone E = 1
])
def test_knn_topk_kernel_warp_selection_edges(S, Lq, Lc, k, exclude_self,
                                              select_Es):
    """The warp-parallel selection's edges, bit-equal to the plain version."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    x = _lags(S, 20, max(Lq, Lc) + (0 if exclude_self else Lc), 5)
    if exclude_self:
        Vq = Vc = torch.tensor(x[..., :Lq], device=dev)
    else:
        Vq = torch.tensor(x[..., Lc:Lc + Lq].copy(), device=dev)
        Vc = torch.tensor(x[..., :Lc].copy(), device=dev)
    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es)
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_knn_topk_kernel_constant_series():
    """Every distance ties at 0: the lowest ids win, in id order."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    x = torch.full((2, 20, 300), 0.25, device=dev)
    for Vq, k, excl, sel in ((x, 21, True, tuple(range(1, 21))),
                             (x[..., :100].contiguous(), 32, False, (1, 7, 20))):
        ki, kd = knn_topk(Vq, x, k, excl, sel)
        ri, rd = knn_topk_ref(Vq, x, k, excl, sel)
        assert torch.equal(ki, ri)
        assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_knn_topk_kernel_k_equals_Lc():
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    x = torch.tensor(_lags(2, 5, 21, 1)[..., :21], device=dev)
    ki, kd = knn_topk(x, x, 21, True, range(1, 6))
    ri, rd = knn_topk_ref(x, x, 21, True, range(1, 6))
    assert torch.equal(ki, ri) and torch.isinf(kd[..., -1]).all()
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_knn_topk_kernel_refuses_what_it_does_not_take():
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk

    x = torch.zeros((1, 4, 40), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        knn_topk(x, x, 3, True, (1,), dist_dtype="float16")
    with pytest.raises(ValueError, match="k="):
        knn_topk(x, x, 33, True, (1,))
    with pytest.raises(ValueError, match="contiguous"):
        knn_topk(x[..., ::2], x[..., ::2], 3, True, (1,))
    with pytest.raises(ValueError, match="one CUDA device"):
        knn_topk(x, x.cpu(), 3, True, (1,))


@pytest.mark.parametrize("S,Lq,k,B,Lp", [(None, 1430, 21, 2048, 1430),
                                          (8, 1430, 13, 300, 1430),
                                          (3, 257, 5, 33, 300)])
def test_ccm_lookup_kernel_equals_plain_version(S, Lq, k, B, Lp):
    dev = _card()
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

    rng = np.random.default_rng(2)
    lead = () if S is None else (S,)
    idx = torch.tensor(rng.integers(0, Lp, lead + (Lq, k)).astype(np.int32), device=dev)
    w = torch.tensor(rng.uniform(0, 1, lead + (Lq, k)).astype(np.float32), device=dev)
    Y = torch.tensor(rng.standard_normal((B, Lp)).astype(np.float32), device=dev)
    got, want = ccm_lookup(idx, w, Y), ccm_lookup_ref(idx, w, Y)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(Y.abs().max())


# segment counts around every group width G of the staged kernel (8, 4, 2:
# G - 1, G and G + 1 targets), single targets and an empty segment; past
# Lp = 7,168 the stream kernel takes one target at a time
LOOKUP_SEG_COUNTS = (1, 7, 8, 9, 0, 3, 4, 5, 2, 1, 17)


@pytest.mark.parametrize("S,nb,Lq,k,Lp", [
    (8, 3, 1430, 21, 1430),   # the main path's shape, G = 8
    (2, 4, 257, 1, 300),      # ragged Lq, k = 1
    (3, 2, 1000, 32, 2000),   # k = 32, G = 4
    (2, 3, 300, 13, 5000),    # G = 2
    (2, 2, 700, 21, 8528),    # Subject11's series length: the stream kernel
    (1, 2, 129, 8, 16384),    # the stream kernel at Lp = 16,384
    (3, 2, 8508, 1, 8528),    # stream, k = 1, blocks of pairs across tables
    (2, 3, 1000, 32, 9001),   # stream, k = 32, Lp % 4 != 0 (4-byte copies)
])
def test_ccm_lookup_segmented_kernel_equals_plain_version(S, nb, Lq, k, Lp):
    dev = _card()
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

    rng = np.random.default_rng(Lp)
    segs = tuple((i % nb, c) for i, c in enumerate(LOOKUP_SEG_COUNTS))
    B = sum(c for _, c in segs)
    idx = rng.integers(0, Lp, (S, nb, Lq, k)).astype(np.int32)
    idx[:, :, 0] = 0          # the first and the last target point
    idx[:, :, -1] = Lp - 1
    idx = torch.tensor(idx, device=dev)
    w = torch.tensor(rng.uniform(0, 1, (S, nb, Lq, k)).astype(np.float32), device=dev)
    Y = torch.tensor(rng.standard_normal((B, Lp)).astype(np.float32), device=dev)
    got, want = ccm_lookup(idx, w, Y, segs), ccm_lookup_ref(idx, w, Y, segs)
    assert got.shape == want.shape == (S, B, Lq)
    assert float((got - want).abs().max()) <= 1e-6 * float(Y.abs().max())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ccm_lookup_kernel_refuses_what_it_does_not_take():
    dev = _card()
    from repro_torch.kernels.ccm_lookup.ops import _lib, ccm_lookup

    max_lp = _lib().ccm_lookup_max_lp()
    assert max_lp >= 16384
    idx = torch.zeros((1, 1, 4, 3), dtype=torch.int32, device=dev)
    w = torch.ones((1, 1, 4, 3), device=dev)
    with pytest.raises(ValueError, match=f"limit {max_lp}"):
        ccm_lookup(idx, w, torch.zeros((2, max_lp + 1), device=dev), ((0, 2),))
    Y = torch.zeros((2, 10), device=dev)
    with pytest.raises(ValueError, match="k=33"):
        ccm_lookup(torch.zeros((1, 1, 4, 33), dtype=torch.int32, device=dev),
                   torch.ones((1, 1, 4, 33), device=dev), Y, ((0, 2),))
    with pytest.raises(ValueError, match="must cover"):
        ccm_lookup(idx, w, Y, ((0, 1),))
    with pytest.raises(ValueError, match="must cover"):
        ccm_lookup(idx, w, Y, ((1, 2),))
    with pytest.raises(ValueError, match="at most 64"):
        ccm_lookup(idx, w, torch.zeros((65, 10), device=dev), ((0, 1),) * 65)


def test_cuda_engine_map_matches_torch_reference_on_the_card():
    dev = _card()
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    ts = dummy_brain(40, 500, seed=3)
    got = run_causal_inference(ts, EDMConfig(E_max=10), device=dev)
    want = run_causal_inference(ts, EDMConfig(E_max=10, engine="torch-reference"),
                                device=dev)
    assert np.array_equal(got.optE, want.optE)
    assert np.abs(got.rho - want.rho).max() <= 1e-5


@pytest.mark.parametrize("exclude_self,buckets,k,permuted,lib_sizes", [
    (True, (3, 5, 8, 12), 13, True, (100, 200, 400)),
    (True, tuple(range(1, 21)), 21, True, (22, 150, 400)),
    (True, (3, 5, 8, 12), 13, False, (14, 399, 400)),
    (False, (2, 7), 8, True, (8, 333)),
])
def test_knn_topk_prefix_kernel_equals_plain_version(exclude_self, buckets, k,
                                                     permuted, lib_sizes):
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref

    x = torch.tensor(_lags(4, 20, 400, 3), device=dev)
    col_ids = None
    if permuted:
        perm = np.random.default_rng(4).permutation(400).astype(np.int32)
        col_ids = torch.tensor(perm, device=dev)
    ki, kd = knn_topk_prefix(x, x, k, exclude_self, buckets, lib_sizes,
                             col_ids=col_ids)
    ri, rd = knn_topk_prefix_ref(x, x, k, exclude_self, buckets, lib_sizes,
                                 col_ids=col_ids)
    assert ki.shape == (4, len(lib_sizes), len(buckets), 400, k)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


@pytest.mark.parametrize("Lq,Lc,k,exclude_self,buckets,lib_sizes,order", [
    # library sizes ending inside 32-wide groups of the sweep
    (1430, 1430, 13, True, (3, 5, 8, 12), (45, 100, 1430), "permuted"),
    # several sizes inside one group; the self column of the query at
    # sweep position 44 / 45 lies on either side of a snapshot
    (400, 400, 13, True, (3, 5, 8, 12), (40, 45, 60, 400), "permuted"),
    (400, 400, 13, True, (3, 5, 8, 12), (14, 100, 400), "permuted"),  # k + 1
    (5, 400, 9, False, (2, 8), (40, 77, 400), "permuted"),      # Lq below 8
    (1, 400, 21, False, tuple(range(1, 21)), (21, 333), "permuted"),  # Lq 1
    (400, 400, 21, True, tuple(range(1, 21)), (22, 50, 300), "constant"),
    (400, 400, 13, True, (3, 5, 8, 12), (45, 100, 400), "natural"),
])
def test_knn_topk_prefix_kernel_snapshot_edges(Lq, Lc, k, exclude_self, buckets,
                                               lib_sizes, order):
    """The warp-parallel prefix selection's edges, bit-equal to the plain
    version; "constant" is a constant series under a permuted sweep, so
    every distance ties and the earliest sweep position must win."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref

    x = _lags(3, 20, Lc + (0 if exclude_self else Lq), 6)
    if order == "constant":
        x[:] = 0.25
    if exclude_self:
        Vq = Vc = torch.tensor(x[..., :Lc], device=dev)
    else:
        Vq = torch.tensor(x[..., Lc:Lc + Lq].copy(), device=dev)
        Vc = torch.tensor(x[..., :Lc].copy(), device=dev)
    col_ids = None
    if order != "natural":
        perm = np.random.default_rng(Lq).permutation(Lc).astype(np.int32)
        col_ids = torch.tensor(perm, device=dev)
    ki, kd = knn_topk_prefix(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                             col_ids=col_ids)
    ri, rd = knn_topk_prefix_ref(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                                 col_ids=col_ids)
    assert ki.shape == (3, len(lib_sizes), len(buckets), Lq, k)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_knn_topk_prefix_kernel_refuses_what_it_does_not_take():
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix

    x = torch.zeros((1, 4, 40), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        knn_topk_prefix(x, x, 3, True, (1,), (10, 40), dist_dtype="float16")
    with pytest.raises(ValueError, match="too small"):
        knn_topk_prefix(x, x, 3, True, (1,), (3, 40))
    with pytest.raises(ValueError, match="col_ids int32"):
        knn_topk_prefix(x, x, 3, True, (1,), (10, 40),
                        col_ids=torch.arange(40, device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        knn_topk_prefix(x, x.cpu(), 3, True, (1,), (10, 40))


def test_prng_on_the_card_equals_the_cpu():
    dev = _card()
    from repro_torch.inference import prng

    kc, kd = prng.prng_key(7), prng.prng_key(7, dev)
    assert torch.equal(prng.permutation(kd, 8508).cpu(), prng.permutation(kc, 8508))
    u = prng.uniform(prng.split(kd, 5), 726, 0.0, prng.TWO_PI_F32).cpu()
    assert torch.equal(u.view(torch.int32), prng.uniform(
        prng.split(kc, 5), 726, 0.0, prng.TWO_PI_F32).view(torch.int32))


def test_cuda_engine_significance_matches_torch_reference_on_the_card():
    dev = _card()
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(24, 500, seed=3)
    cmap = run_causal_inference(ts, EDMConfig(E_max=10), device=dev)
    sig = SignificanceConfig(lib_sizes=(50, 200, 490), n_surrogates=9, seed=0)
    got = run_significance(ts, cmap.optE, cmap.rho, EDMConfig(E_max=10), sig,
                           device=dev)
    want = run_significance(ts, cmap.optE, cmap.rho,
                            EDMConfig(E_max=10, engine="torch-reference"), sig,
                            device=dev)
    assert np.abs(got.drho - want.drho).max() <= 1e-5
    # same tables, lookups equal as a rule: allow a flip only at a near-tie
    assert (got.pvals != want.pvals).mean() <= 0.01
    assert (got.trend != want.trend).mean() <= 0.01


# ------------------------------------------- the bfloat16 accumulator
def _tied(S, E, L, seed):
    """Lags quantised to quarter steps: many equal distances, and more
    once bfloat16 rounds them."""
    x = np.random.default_rng(seed).standard_normal((S, E, L))
    return (np.round(x * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("case,S,Lq,Lc,k,exclude_self,select_Es", [
    ("phase2", 8, 1430, 1430, 18, True, (3, 5, 8, 12, 17)),
    ("phase1", 8, 715, 715, 21, False, tuple(range(1, 21))),
    ("tied", 3, 400, 400, 21, True, tuple(range(1, 21))),
    ("k_32", 2, 300, 300, 32, True, (4, 11, 20)),
])
def test_knn_topk_kernel_bf16_equals_plain_version(case, S, Lq, Lc, k,
                                                   exclude_self, select_Es):
    """The bf16 accumulator, bit-equal to the plain bf16 version (eager
    PyTorch's bf16 ops), ties included."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    make = _tied if case == "tied" else _lags
    x = make(S, 20, Lq + (0 if exclude_self else Lc), 9)
    if exclude_self:
        Vq = Vc = torch.tensor(x, device=dev)
    else:
        Vq = torch.tensor(x[..., Lc:].copy(), device=dev)
        Vc = torch.tensor(x[..., :Lc].copy(), device=dev)
    before = knn_topk.LAUNCHES
    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es, dist_dtype="bfloat16")
    assert knn_topk.LAUNCHES == before + 1
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es, dist_dtype="bfloat16")
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))
    f32 = knn_topk(Vq, Vc, k, exclude_self, select_Es)[1]
    assert not torch.equal(kd, f32)  # the branch really rounds to bf16


@pytest.mark.parametrize("case,Lq,k,buckets,lib_sizes,permuted", [
    ("sig_shape", 1430, 17, (3, 5, 8, 12, 16), (100, 200, 400, 800, 1430), True),
    ("tied_mid_group", 400, 13, (3, 5, 8, 12), (40, 45, 60, 400), True),
    ("tied_natural", 400, 21, tuple(range(1, 21)), (22, 100, 400), False),
])
def test_knn_topk_prefix_kernel_bf16_equals_plain_version(case, Lq, k, buckets,
                                                          lib_sizes, permuted):
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref

    make = _tied if case.startswith("tied") else _lags
    x = torch.tensor(make(4, 20, Lq, 11), device=dev)
    col_ids = None
    if permuted:
        col_ids = torch.tensor(
            np.random.default_rng(5).permutation(Lq).astype(np.int32), device=dev)
    ki, kd = knn_topk_prefix(x, x, k, True, buckets, lib_sizes, col_ids=col_ids,
                             dist_dtype="bfloat16")
    ri, rd = knn_topk_prefix_ref(x, x, k, True, buckets, lib_sizes,
                                 col_ids=col_ids, dist_dtype="bfloat16")
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_kernel_limits_are_the_libraries():
    _card()
    from repro_torch.kernels.ccm_lookup.ops import _lib as lookup_lib
    from repro_torch.kernels.knn_topk.ops import MAX_E, MAX_K, _lib, _prefix_lib

    assert (_lib().knn_topk_max_k(), _lib().knn_topk_max_e()) == (MAX_K, MAX_E)
    assert (_prefix_lib().knn_topk_prefix_max_k(),
            _prefix_lib().knn_topk_prefix_max_e()) == (MAX_K, MAX_E)
    assert lookup_lib().ccm_lookup_max_k() == MAX_K


# ------------------------------------------------ tiled and all-E phase 2
@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("dist_dtype", ["float32", "bfloat16"])
def test_tiled_map_equals_untiled_on_the_card(bucketed, dist_dtype):
    """Tiled == untiled byte for byte with the kernels, at tile widths
    that cut target blocks (of 64) anywhere, odd ones included; and the
    cuda engine's map equals torch-reference's within 1e-5."""
    dev = _card()
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    ts = dummy_brain(150, 500, seed=3)
    cfg = EDMConfig(E_max=10, bucketed=bucketed, target_block=64,
                    dist_dtype=dist_dtype)
    base = run_causal_inference(ts, cfg, device=dev)
    for tile in (7, 33, 64, 100):
        got = run_causal_inference(ts, dataclasses.replace(cfg, target_tile=tile),
                                   device=dev)
        np.testing.assert_array_equal(got.rho, base.rho, err_msg=f"tile {tile}")
    want = run_causal_inference(ts, dataclasses.replace(cfg, engine="torch-reference"),
                                device=dev)
    assert np.array_equal(base.optE, want.optE)
    assert np.abs(base.rho - want.rho).max() <= 1e-5


def test_tiled_significance_equals_untiled_on_the_card():
    dev = _card()
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(70, 500, seed=3)
    cfg = EDMConfig(E_max=10, target_block=64)
    cmap = run_causal_inference(ts, cfg, device=dev)
    sig = SignificanceConfig(lib_sizes=(50, 200, 490), n_surrogates=9, seed=0)
    base = run_significance(ts, cmap.optE, cmap.rho, cfg, sig, device=dev)
    for tile in (9, 32):
        got = run_significance(ts, cmap.optE, cmap.rho,
                               dataclasses.replace(cfg, target_tile=tile), sig,
                               device=dev)
        for a in ("drho", "trend", "pvals"):
            np.testing.assert_array_equal(getattr(got, a), getattr(base, a),
                                          err_msg=f"{a}, tile {tile}")
        np.testing.assert_array_equal(got.edges, base.edges)


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,dtype", [
    (4, 2048, 2048, 16, 2, 128, True, "bfloat16"),
    (2, 1000, 1000, 9, 3, 64, True, "bfloat16"),
    (1, 300, 333, 8, 2, 128, False, "float32"),
    (2, 129, 129, 4, 4, 16, True, "float32"),
    (1, 96, 96, 2, 1, 8, True, "float32"),
    (2, 300, 300, 4, 2, 16, True, "bfloat16"),
    (1, 1024, 1024, 32, 32, 112, True, "bfloat16"),
    (4, 1, 2048, 16, 2, 128, False, "bfloat16"),
    (1, 1000, 1000, 32, 4, 128, True, "bfloat16"),
    (1, 96, 96, 2, 1, 8, True, "bfloat16"),
    (4100, 2, 3, 16, 2, 16, False, "bfloat16"),
])
def test_flash_attn_kernel_equals_plain_version(B, Sq, Sk, H, K, dh, causal, dtype):
    """float32 within 2e-5 and bfloat16 within one bf16 step of the plain
    version's bf16 output (the CUDA-core route); the tensor-core route
    (which rounds p to bf16; docs/PORT.md) against the plain version's
    float32 result: its max error within twice SDPA's on the same inputs
    and 0.04, and each element within 2^-7 |want| plus twice SDPA's max
    error in its row.  B * H 65,600 is above the CUDA-core route's grid
    limit and within the tensor-core route's."""
    dev = _card()
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    rng = np.random.default_rng(Sq + dh)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(dt)
               for s in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh)))
    route = flash_route("cuda", dt, dh)
    before = flash_attn.ROUTE_LAUNCHES[route]
    got = flash_attn(q, k, v, causal)
    assert flash_attn.ROUTE_LAUNCHES[route] == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    if route == "cuda_core":
        want = flash_attn_ref(q, k, v, causal).float()
        atol, rtol = (2e-5, 2e-5) if dtype == "float32" else (1e-6, 2.0 ** -7)
        assert bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())
        return
    want = flash_attn_ref(q.float(), k.float(), v.float(), causal)
    lib = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal,
        enable_gqa=True).transpose(1, 2)
    lib_row = (lib.float() - want).abs().amax(-1, keepdim=True)
    diff = (got.float() - want).abs()
    assert float(diff.max()) <= min(2 * float(lib_row.max()), 0.04)
    assert bool((diff <= 2.0 ** -7 * want.abs() + 2 * lib_row).all())


def test_flash_attn_kernel_refuses_what_it_does_not_take():
    dev = _card()
    from repro_torch.kernels.flash_attn.ops import flash_attn

    x = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="d_head up to 128"):
        big = torch.zeros((1, 8, 2, 256), device=dev)
        flash_attn(big, big, big)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attn(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 8, 16), device=dev).transpose(1, 2)
        flash_attn(t, t, t)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attn(x, x.cpu(), x)
    with pytest.raises(ValueError, match="divisible"):
        flash_attn(torch.zeros((1, 8, 3, 16), device=dev), x, x)
    with pytest.raises(ValueError, match="cannot take"):
        wide, kv = (torch.zeros((4100, 2, h, 8), device=dev) for h in (16, 2))
        flash_attn(wide, kv, kv)  # float32: the CUDA-core route, B * H over 65535
    with pytest.raises(ValueError, match="16-byte aligned"):
        t = torch.zeros(1 + 8 * 2 * 16, device=dev, dtype=torch.bfloat16)[1:]
        t = t.view(1, 8, 2, 16)
        flash_attn(t, t, t)


def test_lm_kernel_route_equals_plain_route_on_the_card():
    """A smoke qwen2.5-3b in float32: chunked (the flash kernel, once per
    layer in prefill) against xla (the dense version) within 1e-5."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), attn_impl="chunked")
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100)).astype(np.int32)
    before = sum(flash_attn.ROUTE_LAUNCHES.values())
    got, _ = make_prefill_step(cfg, device=dev)(model, {"tokens": toks})
    assert sum(flash_attn.ROUTE_LAUNCHES.values()) - before == cfg.n_layers
    want, _ = T.forward(model, {"tokens": toks}, dataclasses.replace(cfg, attn_impl="xla"))
    assert float((got - want).abs().max()) <= 1e-5


# ------------------------------------------------------------------ fleet
@pytest.mark.parametrize("unit_rows", [5, 8])
def test_fleet_of_three_workers_equals_one_process_on_the_card(tmp_path, unit_rows):
    """Three worker processes sharing the card, units of 5 or 8 rows
    (chunks of 5, 3, 2, ... library rows at lib_block 8), give the
    single-process store byte for byte: map, drho, trend, p-values,
    edges.  Lp 491 and a last target block of 6 put the Pearson buffers'
    rows at every alignment and below 16 rows."""
    dev = _card()
    from repro_torch import kernels
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data import store
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance
    from repro_torch.launch import edm_fleet

    ts = dummy_brain(70, 501, seed=3)
    cfg = EDMConfig(E_max=10, target_block=64)
    sig = SignificanceConfig(lib_sizes=(50, 200, 491), n_surrogates=9, seed=0)
    base = tmp_path / "base"
    res = run_causal_inference(ts, cfg, device=dev, out_dir=str(base))
    run_significance(ts, res.optE, np.asarray(res.rho), cfg, sig, device=dev,
                     out_dir=str(base))
    kernels.build_all()
    store.save_dataset(tmp_path / "dataset", ts)
    out = tmp_path / "fleet"
    edm_fleet.init_fleet(out, tmp_path / "dataset", cfg, sig, unit_rows=unit_rows)
    procs = [edm_fleet.spawn_worker(out, f"w{i}") for i in range(3)]
    for p in procs:
        assert p.wait(timeout=600) == 0
    for a in ("causal_map", "rho_conv", "rho_trend", "pvals", "edges"):
        assert ((out / a / "data.npy").read_bytes()
                == (base / a / "data.npy").read_bytes()), a
    assert edm_fleet.fleet_status(out)["complete"]


# ------------------------------------------------------- the slab kernel
@pytest.mark.parametrize("E,Lq,Lc,k,exclude_self,kind", [
    (20, 128, 1000, 21, False, "normal"),
    (20, 130, 1430, 21, True, "normal"),     # ragged Lq, square set
    (20, 128, 777, 21, True, "normal"),      # ragged Lc; self = column q
    (20, 300, 300, 21, True, "ties"),        # duplicated points
    (20, 100, 300, 32, False, "constant"),   # every distance ties at 0
    (2, 10, 10, 12, True, "normal"),         # k above the valid candidates
    (20, 128, 1000, 64, True, "normal"),     # k above the stream kernel's 32
    (3, 40, 40, 128, False, "normal"),       # k == Lc_pad: every padding id
])
def test_knn_slab_kernel_equals_plain_version(E, Lq, Lc, k, exclude_self, kind):
    dev = _card()
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_slab.ref import knn_slab_ref

    x = _lags(1, E, max(Lq, Lc) + Lc, 3)[0]
    if kind == "ties":
        x[:, 150:200] = x[:, :50]
    elif kind == "constant":
        x[:] = 0.25
    if exclude_self and Lq == Lc:
        Vq = Vc = torch.tensor(x[:, :Lq], device=dev)
    else:
        Vq = torch.tensor(x[:, :Lq].copy(), device=dev)
        Vc = torch.tensor(x[:, Lq:Lq + Lc].copy(), device=dev)
    ki, kd = knn_slab(Vq, Vc, k, exclude_self)
    ri, rd = knn_slab_ref(Vq, Vc, k, exclude_self)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


def test_knn_slab_kernel_equals_knn_topk_where_k_fits():
    dev = _card()
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_topk.ops import knn_topk

    V = torch.tensor(_lags(1, 20, 1430, 4)[0], device=dev)
    for excl, Vq, Vc in ((True, V, V),
                         (False, V[:, :128].contiguous(), V[:, 128:].contiguous())):
        si, sd = knn_slab(Vq, Vc, 21, excl)
        ti, td = knn_topk(Vq[None], Vc[None], 21, excl, tuple(range(1, 21)))
        assert torch.equal(si, ti[0])
        assert torch.equal(sd.view(torch.int32), td[0].view(torch.int32))


def test_knn_slab_kernel_refuses_what_it_does_not_take():
    dev = _card()
    from repro_torch.kernels.knn_slab.ops import _lib, knn_slab
    from repro_torch.kernels.knn_slab.ref import PAD

    assert _lib().knn_slab_pad() == PAD
    V = torch.zeros((4, 100), device=dev)
    with pytest.raises(ValueError, match="Lc_pad=128"):
        knn_slab(V, V, 129, True)
    with pytest.raises(ValueError, match="float32"):
        knn_slab(V.double(), V.double(), 4, True)
    with pytest.raises(ValueError, match="CUDA device"):
        knn_slab(V, V.cpu(), 4, True)
    with pytest.raises(ValueError, match="contiguous"):
        knn_slab(V[:, ::2], V[:, ::2], 4, True)
