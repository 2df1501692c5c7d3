"""Each CUDA kernel of the port against its plain version on the card.

Marked ``gpu``; run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Without a card every test here skips from inside its body (never at
collection, so every pytest worker collects the same tests)."""
import dataclasses
import json

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
    (4, 2048, 2048, 48, 8, 128, True, "bfloat16"),  # dbrx-132b's prefill, group 6
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


#: (B, S, H, K, dh, n ranks, chunk): a rank's rows of sequence-parallel attention
POSITION_CASES = [(1, 2048, 36, 36, 64, 16, 512), (2, 1024, 9, 3, 64, 4, 256),
                  (1, 1000, 4, 2, 16, 4, 200)]


def _pos_gate(got, want, lib_row, dtype):
    """flash's gates (as test_flash_attn_kernel_equals_plain_version)."""
    diff = (got.float() - want).abs()
    if dtype == "float32":
        return bool((diff <= 2e-5 + 2e-5 * want.abs()).all())
    return (float(diff.max()) <= min(2 * float(lib_row.max()), 0.04)
            and bool((diff <= 2.0 ** -7 * want.abs() + 2 * lib_row).all()))


@pytest.mark.parametrize("layout", ["striped", "contiguous"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,dh,n,chunk", POSITION_CASES)
def test_flash_attn_kernel_with_positions_equals_plain_version(B, S, H, K, dh, n, chunk,
                                                               dtype, layout):
    """Every rank's rows at their positions (striped: C / n rows of every
    chunk of C; contiguous: S / n rows) against the plain version within
    flash's gates, on both routes; stitched, against the unsharded kernel
    within the same gates (float32, or one bf16 step)."""
    dev = _card()
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import block_positions, flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.sharding.attention import seq_rank_rows, seq_stitch

    rng = np.random.default_rng(S + n)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev).to(dt)
               for s in ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
    if layout == "striped":
        if chunk % n or S % chunk:
            pytest.skip("the chunk is not split evenly")
        block, period = chunk // n, chunk
    else:
        block, period = S // n, S
    route = flash_route("cuda", dt, dh)
    before = flash_attn.POSITION_LAUNCHES[route]
    parts = []
    for r in range(n):
        rows = seq_rank_rows(q, r, n, block, period).contiguous()
        pos = block_positions(S // n, block, period, r * block, dev)
        got = flash_attn(rows, k, v, True, pos)
        want = flash_attn_ref(rows.float(), k.float(), v.float(), True, pos)
        lib_row = None
        if dtype == "bfloat16":
            mask = pos[:, None] >= torch.arange(S, device=dev)[None, :]
            lib = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (rows, k, v)), attn_mask=mask,
                enable_gqa=True).transpose(1, 2)
            lib_row = (lib.float() - want).abs().amax(-1, keepdim=True)
        assert _pos_gate(got, want, lib_row, dtype), (r, float((got.float() - want).abs().max()))
        parts.append(got)
    assert flash_attn.POSITION_LAUNCHES[route] == before + n
    whole = flash_attn(q, k, v, True).float()
    stitched = seq_stitch(parts, n, block, period).float()
    atol, rtol = (2e-5, 2e-5) if dtype == "float32" else (1e-6, 2.0 ** -7)
    assert bool(((stitched - whole).abs() <= atol + rtol * whole.abs()).all())


def test_flash_attn_positions_refused_where_the_kernel_cannot_take_them():
    dev = _card()
    from repro_torch.kernels.flash_attn.ops import flash_attn

    x = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="q_pos"):
        flash_attn(x, x, x, True, torch.arange(7, device=dev))
    with pytest.raises(ValueError, match="q_pos"):
        flash_attn(x, x, x, True, torch.arange(8))


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


@pytest.mark.parametrize("arch,launches", [("dbrx-132b", 2), ("mamba2-2.7b", 0)])
def test_moe_and_ssm_kernel_route_equal_plain_route_on_the_card(arch, launches):
    """Smoke dbrx-132b and mamba2-2.7b in float32: the chunked route (the
    flash kernel once per attention layer in prefill; mamba2 has none)
    against the xla route within 1e-5, and the decode after the prefill
    against the forward at that position within 1e-5."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl="chunked")
    if cfg.n_experts:  # drop-free: the prompt and the sequence group alike
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_tok)
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 101)).astype(np.int32)
    before = sum(flash_attn.ROUTE_LAUNCHES.values())
    got, cache = make_prefill_step(cfg, device=dev)(model, {"tokens": toks[:, :100]})
    assert sum(flash_attn.ROUTE_LAUNCHES.values()) - before == launches == (
        cfg.n_layers if cfg.family == "moe" else 0)
    want, _ = T.forward(model, {"tokens": toks}, dataclasses.replace(cfg, attn_impl="xla"))
    assert float((got - want[:, :100]).abs().max()) <= 1e-5
    if cfg.family == "moe":  # the decode's cache needs room for token 100
        big = T.init_cache(cfg, 2, 101, device=dev)
        big["k"][:, :, :100], big["v"][:, :, :100] = cache["k"], cache["v"]
        cache = big
    ld, _ = make_decode_step(cfg, device=dev)(model, {"token": toks[:, 100:], "pos": 100},
                                              cache)
    assert float((ld[:, 0] - want[:, 100]).abs().max()) <= 1e-5


@pytest.mark.parametrize("arch,launches", [("zamba2-7b", 2), ("whisper-medium", 6),
                                           ("llama-3.2-vision-11b", 10)])
def test_hybrid_audio_vlm_kernel_route_equal_plain_route_on_the_card(arch, launches):
    """Smoke zamba2-7b, whisper-medium and llama-3.2-vision-11b in float32,
    the LoRA b and gates drawn non-zero: the chunked route's prefill (the
    flash kernel once a shared-block application; encoder, decoder and
    cross layers; self and cross layers) against the xla route's forward
    within 1e-5, and the decode after it against the forward at that
    position."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl="chunked")
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    g = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("b_q", "b_k", "b_v", "gate_attn", "gate_mlp"):
                prm.uniform_(0.3, 0.9, generator=g)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 101)).astype(np.int32)
    front = {}
    if cfg.family in T.FRONTEND:
        front[T.FRONTEND[cfg.family]] = (0.1 * rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    before = sum(flash_attn.ROUTE_LAUNCHES.values())
    got, _ = make_prefill_step(cfg, device=dev)(model, {"tokens": toks[:, :100], **front})
    assert sum(flash_attn.ROUTE_LAUNCHES.values()) - before == launches
    want, _ = T.forward(model, {"tokens": toks, **front},
                        dataclasses.replace(cfg, attn_impl="xla"))
    assert float((got - want[:, :100]).abs().max()) <= 1e-5
    cache = T.init_cache(cfg, 2, 101, device=dev)
    T.prefill(model, {"tokens": toks[:, :100], **front}, cache, cfg)
    ld, _ = make_decode_step(cfg, device=dev)(model, {"token": toks[:, 100:], "pos": 100},
                                              cache)
    assert float((ld[:, 0] - want[:, 100]).abs().max()) <= 1e-5


def test_bare_flash_attn_under_grad_raises_on_the_card():
    """The kernel has no backward: a bare call on CUDA tensors that require
    grad, with grad mode on, raises instead of returning a tensor without
    autograd history; under no_grad it runs."""
    dev = _card()
    from repro_torch.kernels.flash_attn.ops import flash_attn

    q = torch.randn(1, 64, 2, 16, device=dev, requires_grad=True)
    k, v = torch.randn(1, 64, 2, 16, device=dev), torch.randn(1, 64, 2, 16, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attn(q, k, v, True)
    with torch.no_grad():
        assert not flash_attn(q, k, v, True).requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fn_grads_equal_plain_version_on_the_card(dtype):
    """FlashAttnFn (kernel forward, plain chunked backward) against the plain
    version's autograd at 300 queries in chunks of 128, GQA: float32 (the
    CUDA-core route) within 2e-5; bfloat16 (tensor-core) within one bf16
    step of the plain version's float32 gradients plus 2e-2."""
    dev = _card()
    from repro_torch.kernels.flash_attn.ops import FlashAttnFn
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    g = torch.Generator(dev).manual_seed(0)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in ((2, 300, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64),
                             (2, 300, 8, 64)))

    def grads(fn, *xs):
        xs = [x.detach().requires_grad_() for x in xs]
        o = fn(*xs)
        return (o.detach(), *torch.autograd.grad(o, xs, do.to(o.dtype)))

    got = grads(lambda a, b, c: FlashAttnFn.apply(a, b, c, True, 128), q, k, v)
    want = grads(lambda a, b, c: flash_attn_ref(a, b, c, True), q.float(), k.float(),
                 v.float())
    for a, w in zip(got, want):
        assert a.dtype == dt
        tol = (2e-5 + 2e-5 * w.abs() if dtype == "float32"
               else 2.0 ** -7 * w.abs() + 2e-2)
        assert bool(((a.float() - w).abs() <= tol).all())


def test_train_loss_and_grads_kernel_route_equal_plain_route_on_the_card():
    """A smoke minicpm-2b in float32 under remat: the loss and every
    gradient on the chunked route (the flash kernel in the forward and the
    recompute) against the xla route within 1e-5."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True), attn_impl="chunked")
    model = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100)).astype(np.int32)
    out = {}
    for impl in ("chunked", "xla"):
        before = sum(flash_attn.ROUTE_LAUNCHES.values())
        loss, _ = T.loss_fn(model, {"tokens": toks}, dataclasses.replace(cfg, attn_impl=impl),
                            TrainConfig(remat=True))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[impl] = (loss.item(), grads, sum(flash_attn.ROUTE_LAUNCHES.values()) - before)
    assert out["chunked"][2] == 2 * cfg.n_layers and out["xla"][2] == 0
    assert abs(out["chunked"][0] - out["xla"][0]) <= 1e-5 * abs(out["xla"][0])
    for a, b in zip(out["chunked"][1], out["xla"][1]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


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
@pytest.mark.parametrize("E,Lq,Lc,k,exclude_self,kind,route", [
    (20, 128, 1000, 21, False, "normal", "filter"),
    (20, 130, 1430, 21, True, "normal", "filter"),     # ragged Lq, square set
    (20, 128, 777, 21, True, "normal", "filter"),      # ragged Lc; self = column q
    (20, 300, 300, 21, True, "ties", "filter"),        # duplicated points
    (20, 100, 300, 32, False, "constant", "filter"),   # every distance ties at 0
    (2, 10, 10, 12, True, "normal", "filter"),         # k above the valid candidates
    (20, 128, 1000, 64, True, "normal", "filter"),     # k above the stream kernel's 32
    (3, 40, 40, 128, False, "normal", "filter"),       # k == Lc_pad: every padding id
    (20, 128, 16000, 21, False, "normal", "filter"),   # the row in shared memory
    (20, 128, 60000, 21, False, "normal", "filter"),   # the row's tail in the workspace
    (20, 64, 16000, 21, True, "constant", "filter"),   # value ties: the column decides
    (20, 64, 16000, 2000, False, "normal", "search"),  # the candidate buffer overflows
    (5, 16, 16000, 2100, True, "normal", "search"),    # k above the buffer's capacity
    (3, 8, 5000, 5120, True, "ties", "search"),        # k == Lc_pad, three chunks
])
def test_knn_slab_kernel_equals_plain_version(E, Lq, Lc, k, exclude_self, kind,
                                              route):
    """Bit-equal to the plain version, and every (row, lag) selection took
    the expected route (the kernel's device counters): ``filter`` where
    the threshold's candidates fit the buffer of ``knn_slab_capacity()``
    keys, ``search`` where they overflow it or k exceeds it."""
    dev = _card()
    from repro_torch.kernels.knn_slab.ops import (_lib, knn_slab,
                                                  reset_route_counts,
                                                  route_counts)
    from repro_torch.kernels.knn_slab.ref import knn_slab_ref

    assert _lib().knn_slab_capacity() == 2048
    x = _lags(2, E, max(Lq, Lc) + Lc, 3)[0]  # series 1 is the constant one
    if kind == "ties":
        x[:, 150:200] = x[:, :50]
    elif kind == "constant":
        x[:] = 0.25
    if exclude_self and Lq == Lc:
        Vq = Vc = torch.tensor(x[:, :Lq], device=dev)
    else:
        Vq = torch.tensor(x[:, :Lq].copy(), device=dev)
        Vc = torch.tensor(x[:, Lq:Lq + Lc].copy(), device=dev)
    knn_slab(Vq, Vc, k, exclude_self)  # builds the library, sets up the counters
    reset_route_counts()
    ki, kd = knn_slab(Vq, Vc, k, exclude_self)
    routes = route_counts()
    ri, rd = knn_slab_ref(Vq, Vc, k, exclude_self)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))
    assert routes[route] == E * Lq, routes
    assert routes["filter"] + routes["search"] == E * Lq, routes


def test_knn_slab_kernel_equals_knn_topk_where_k_fits():
    dev = _card()
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_topk.ops import knn_topk

    V = torch.tensor(_lags(2, 20, 1430, 4)[0], device=dev)
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


@pytest.mark.parametrize("lo,hi,width,k,exclude_self,dist_dtype", [
    (0, 200, 200, 21, True, "float32"),      # the default range, explicit
    (200, 400, 200, 21, True, "float32"),    # a shard at an offset
    (330, 400, 77, 21, True, "float32"),     # a padded last shard
    (420, 400, 50, 21, True, "float32"),     # a shard wholly past Lc
    (100, 300, 200, 32, False, "float32"),
    (200, 400, 200, 21, True, "bfloat16"),
    (330, 400, 77, 13, False, "bfloat16"),
])
def test_knn_topk_kernel_column_range_equals_plain_version(lo, hi, width, k,
                                                           exclude_self,
                                                           dist_dtype):
    """Shard tables (global ids, masked columns +inf with their own ids,
    exclude_self by global id) bit-equal to the plain version."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    x = _lags(3, 20, 400, 9)
    part = np.zeros((3, 20, width), np.float32)
    n = max(0, min(hi, 400) - lo)
    part[..., :n] = x[..., lo:lo + n]
    Vq, Vc = torch.tensor(x, device=dev), torch.tensor(part, device=dev)
    sel = (3, 5, 8, 12, 20)
    ki, kd = knn_topk(Vq, Vc, k, exclude_self, sel, dist_dtype=dist_dtype,
                      col_offset=lo, col_hi=hi)
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, sel, dist_dtype=dist_dtype,
                          col_offset=lo, col_hi=hi)
    assert torch.equal(ki, ri)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32))


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_library_sharded_on_the_card_equals_the_unsharded_kernel_table(S):
    dev = _card()
    from repro_torch.core.pipeline import (knn_tables_library_sharded,
                                           knn_tables_library_sharded_sim)
    from repro_torch.core.types import EDMConfig
    from repro_torch.kernels.knn_topk.ops import knn_topk

    V = torch.tensor(_lags(2, 20, 700, 4), device=dev)
    cfg = EDMConfig(E_max=20)
    ui, ud = knn_topk(V, V, 21, True, tuple(range(1, 21)))
    for got in (knn_tables_library_sharded_sim(V, V, 21, cfg, exclude_self=True,
                                               shards=S),
                knn_tables_library_sharded(V, V, 21, cfg, exclude_self=True,
                                           devices=[dev] * S)):
        assert torch.equal(got[0], ui)
        assert torch.equal(got[1].view(torch.int32), ud.view(torch.int32))


def test_main_path_over_two_slots_on_the_card_equals_one_slot():
    dev = _card()
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    ts = dummy_brain(96, 500, seed=2)
    for tile in (0, 40):
        cfg = EDMConfig(E_max=12, target_tile=tile)
        one = run_causal_inference(ts, cfg, device=[dev])
        two = run_causal_inference(ts, cfg, device=[dev, dev])
        assert one.rho.tobytes() == two.rho.tobytes()


@pytest.mark.parametrize("E_max,L,series", [(6, 120, 2), (20, 1430, 3)])
def test_check_engine_cuda_on_the_card(E_max, L, series):
    """``python -m repro_torch.engine.check --engine cuda``'s check: every
    op of the cuda engine against torch-reference on the card."""
    _card()
    from repro_torch.engine.check import TOLERANCES, check_engine

    errs = check_engine("cuda", E_max=E_max, Lq=L, Lc=L, n_targets=37,
                        series=series)
    assert set(errs) == set(TOLERANCES)


def test_extensions_on_the_card_run_knn_topk_and_equal_the_plain_route():
    dev = _card()
    from repro_torch.core import extensions as ext
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import coupled_logistic
    from repro_torch.kernels.knn_topk.ops import knn_topk

    x, y = coupled_logistic(800, beta_xy=0.0, beta_yx=0.12, seed=3)
    xs, ys = np.stack([y, x]), np.stack([x, y])
    for E_max, E in ((6, 3), (20, 12)):
        knn_topk.LAUNCHES = 0
        got = ext.ccm_lagged(xs, ys, E, EDMConfig(E_max=E_max), device=dev)
        assert knn_topk.LAUNCHES == 1 and got.device.type == "cuda"
        want = ext.ccm_lagged(xs, ys, E, EDMConfig(E_max=E_max,
                                                   engine="torch-reference"),
                              device=dev)
        assert torch.equal(got, want)
    # the S-Map's solve on the card against the CPU's, within float32
    # round-off of sums in another order
    got = ext.smap_theta_sweep(xs, 2, EDMConfig(E_max=6), device=dev).cpu()
    want = ext.smap_theta_sweep(xs, 2, EDMConfig(E_max=6), device="cpu")
    assert (got - want).abs().max() <= 1e-5


def test_autotune_stores_equal_with_telemetry_on_off_and_tuned_on_the_card(
        tmp_path, monkeypatch):
    """The smoke's ``autotune`` phase at a small size: A ``--autotune``
    (records, writes tuned.json), B ``--autotune --tune-from A`` (one
    chunk of every row: other launches), C ``--no-telemetry``: the maps
    byte-equal; C leaves no telemetry and no history; tuned.json is A's
    fresh recommendation."""
    dev = _card()
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.launch import edm_run
    from repro_torch.runtime import autotune

    monkeypatch.delenv("EDM_HISTORY", raising=False)
    monkeypatch.delenv("EDM_TELEMETRY", raising=False)
    base = ["--synthetic", "96x500", "--e-max", "10"]
    a, b, c = (tmp_path / x for x in "abc")
    launches = {}
    for out, extra in ((a, ["--autotune"]),
                       (b, ["--autotune", "--tune-from", str(a)]),
                       (c, ["--no-telemetry"])):
        knn_topk.LAUNCHES = 0
        summary = edm_run.main([*base, *extra, "--out", str(out)])
        launches[out.name] = knn_topk.LAUNCHES
        assert summary["device"] == dev.type
    maps = [(d / "causal_map" / "data.npy").read_bytes() for d in (a, b, c)]
    assert maps[0] == maps[1] == maps[2]
    assert not (c / "telemetry").exists() and not (c / "history.jsonl").exists()
    tuned = json.loads((a / "tuned.json").read_text())
    assert tuned == autotune.recommend(a)
    assert tuned["recommend"]["chunk_rows"] == 96  # clamped to N
    assert launches["b"] == 2 < launches["c"]  # one chunk in each phase


@pytest.fixture
def one_rank_world():
    """A world of one NCCL rank on card 0 (mesh (1, 1)), torn down after."""
    dev = _card()
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,opt", [("dbrx-132b", "adafactor"), ("mamba2-2.7b", "adamw")])
def test_moe_and_ssm_sharded_at_one_by_one_equal_one_process_on_the_card(one_rank_world,
                                                                         arch, opt):
    """Smoke dbrx-132b and mamba2-2.7b in float32 on one NCCL rank at mesh
    (1, 1), the state created shard by shard: one train step against the
    single-process step (loss within 1e-6 relative, parameters rtol 2e-3 /
    atol 2e-5), prefill and two decode steps within 1e-5, the flash
    kernel once a layer in the sharded prefill (mamba2: never), and the
    routed and dropped counts equal."""
    dev = one_rank_world
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (TrainState, make_decode_step, make_prefill_step,
                                          make_train_step)
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl="chunked")
    tc = TrainConfig(optimizer=opt, remat=False, lr=1e-3, warmup_steps=1, total_steps=5)
    pol = ShardingPolicy(mesh=make_local_mesh(model=1, device=dev), fsdp=True)
    gen = lambda: torch.Generator(dev).manual_seed(0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 18)).astype(np.int32)
    step = make_train_step(cfg, tc, device=dev)
    one, sharded = (TrainState.create(cfg, tc, gen(), device=dev),
                    TrainState.create(cfg, tc, gen(), device=dev, policy=pol))
    got = []
    for st in (one, sharded):
        MOE.reset_drop_counts(st.params)
        st, m = step(st, {"tokens": toks[:, :16]})
        got.append((float(m["loss"]), MOE.drop_counts(st.params), st))
    assert abs(got[1][0] - got[0][0]) <= 1e-6 * abs(got[0][0])
    assert got[1][1] == got[0][1]
    for (k, a), (_, b) in zip(got[0][2].params.named_parameters(),
                              got[1][2].params.named_parameters()):
        np.testing.assert_allclose(PL.full(b).detach().cpu().numpy(),
                                   a.detach().cpu().numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=k)
    params = T.init_params(cfg, gen(), dev)
    sparams = PL.init_sharded(cfg, ShardingPolicy(mesh=pol.mesh), gen())
    want, cache = make_prefill_step(cfg, device=dev)(params, {"tokens": toks[:, :16]})
    before = sum(flash_attn.ROUTE_LAUNCHES.values())
    lg, scache = make_prefill_step(cfg, policy=ShardingPolicy(mesh=pol.mesh), device=dev)(
        sparams, {"tokens": toks[:, :16]})
    assert sum(flash_attn.ROUTE_LAUNCHES.values()) - before == (
        cfg.n_layers if cfg.family == "moe" else 0)
    assert float((PL.full(lg) - want).abs().max()) <= 1e-5
    if "k" in cache:
        big = T.init_cache(cfg, 4, 18, device=dev)
        big["k"][:, :, :16], big["v"][:, :, :16] = cache["k"], cache["v"]
        cache = big
    scache = PL.grow_cache(scache, cfg, 18, ShardingPolicy(mesh=pol.mesh))
    decode = make_decode_step(cfg, device=dev)
    for i in (16, 17):
        want, cache = decode(params, {"token": toks[:, i : i + 1], "pos": i}, cache)
        lg, scache = decode(sparams, {"token": toks[:, i : i + 1], "pos": i}, scache)
        assert float((PL.full(lg) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_split_softmax_over_a_seq_sharded_cache_equals_plain_attention_on_the_card(
        one_rank_world, dtype):
    """Non-causal attention of one decode token over a cross cache sharded
    along the source sequence (whisper-medium's 1,500 frames, H = K = 16,
    dh 64) on one NCCL rank at mesh (1, 1): the split softmax of
    ``sharding/attention.py`` against the plain attention on the whole
    tensors (float32 within 2e-6; bfloat16 within one bf16 step)."""
    dev = one_rank_world
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import attention as SA
    from repro_torch.sharding import place as PL

    mesh = make_local_mesh(model=1, device=dev)
    dt = getattr(torch, dtype)
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((4, 1, 16, 64), (4, 1500, 16, 64), (4, 1500, 16, 64)))
    want = flash_attn_ref(q, k, v, False)
    rep = [Replicate(), Replicate()]
    with torch.inference_mode():
        got = SA.cross_attention(PL.place(q, mesh, [Replicate(), Shard(2)]),
                                 PL.place(k, mesh, [Replicate(), Shard(1)]),
                                 PL.place(v, mesh, [Replicate(), Shard(1)]))
    assert SA._seq_shard_dim(PL.place(k, mesh, [Replicate(), Shard(1)])) == 1
    got = PL.full(got.redistribute(mesh, rep))
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    err = (got.float() - want.float()).abs() - tol * (1 + want.float().abs())
    assert float(err.max()) <= 0.0


@pytest.mark.parametrize("arch,opt", [("zamba2-7b", "adamw"), ("whisper-medium", "adamw"),
                                      ("llama-3.2-vision-11b", "adafactor")])
def test_hybrid_audio_vlm_sharded_at_one_by_one_equal_one_process_on_the_card(
        one_rank_world, arch, opt):
    """Smoke zamba2-7b, whisper-medium and llama-3.2-vision-11b in float32
    on one NCCL rank at mesh (1, 1), the state created shard by shard and
    the zero-initialised LoRA b and gates drawn non-zero: one train step
    against the single-process step (loss within 1e-6 relative,
    parameters rtol 2e-3 / atol 2e-5), prefill and two decode steps (the
    cross cache along the source sequence) within 1e-5, and the flash
    kernel as often in the sharded prefill as in one process's."""
    dev = one_rank_world
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (TrainState, make_decode_step, make_prefill_step,
                                          make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl="chunked")
    tc = TrainConfig(optimizer=opt, remat=False, lr=1e-3, warmup_steps=1, total_steps=5)
    pol = ShardingPolicy(mesh=make_local_mesh(model=1, device=dev), fsdp=True)
    gen = lambda: torch.Generator(dev).manual_seed(0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 18)).astype(np.int32)
    key = T.FRONTEND.get(cfg.family)
    front = ({} if key is None else {key: (0.1 * rng.standard_normal(
        (4, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)})

    def drawn(lm):  # the zero leaves, drawn whole on the card, each rank's slice kept
        g = torch.Generator(dev).manual_seed(1)
        with torch.no_grad():
            for name, p in lm.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("b_q", "b_k", "b_v", "gate_attn", "gate_mlp"):
                    r = 0.3 + 0.6 * torch.rand(p.shape, generator=g, device=dev)
                    PL.local(p).copy_(PL.local(PL.place(r, p.device_mesh, p.placements))
                                      if PL.is_sharded(p) else r)
        return lm

    step = make_train_step(cfg, tc, device=dev)
    got = []
    for st in (TrainState.create(cfg, tc, gen(), device=dev),
               TrainState.create(cfg, tc, gen(), device=dev, policy=pol)):
        drawn(st.params)
        st, m = step(st, {"tokens": toks[:, :16], **front})
        got.append((float(m["loss"]), st))
    assert abs(got[1][0] - got[0][0]) <= 1e-6 * abs(got[0][0])
    for (k, a), (_, b) in zip(got[0][1].params.named_parameters(),
                              got[1][1].params.named_parameters()):
        np.testing.assert_allclose(PL.full(b).detach().cpu().numpy(),
                                   a.detach().cpu().numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=k)
    spol = ShardingPolicy(mesh=pol.mesh)
    params = drawn(T.init_params(cfg, gen(), dev))
    sparams = drawn(PL.init_sharded(cfg, spol, gen()))
    prompt = {"tokens": toks[:, :16], **front}
    launches = []
    for p, pl in ((params, None), (sparams, spol)):
        before = sum(flash_attn.ROUTE_LAUNCHES.values())
        out = make_prefill_step(cfg, policy=pl, device=dev)(p, prompt)
        launches.append(sum(flash_attn.ROUTE_LAUNCHES.values()) - before)
        if pl is None:
            want, cache = out
        else:
            lg, scache = out
    assert launches[0] == launches[1] > 0
    assert float((PL.full(lg) - want).abs().max()) <= 1e-5
    scache = PL.grow_cache(scache, cfg, 18, spol)
    big = T.init_cache(cfg, 4, 18, device=dev)
    src, dst = (cache["attn"], big["attn"]) if "attn" in cache else (cache, big)
    for name in ("k", "v"):
        dst[name].narrow(src[name].ndim - 3, 0, 16).copy_(src[name])
    cache = {**cache, **{n: big[n] for n in ("k", "v", "attn") if n in big}}
    decode = make_decode_step(cfg, device=dev)
    for i in (16, 17):
        want, cache = decode(params, {"token": toks[:, i : i + 1], "pos": i}, cache)
        lg, scache = decode(sparams, {"token": toks[:, i : i + 1], "pos": i}, scache)
        assert float((PL.full(lg) - want).abs().max()) <= 1e-5
