"""The port's significance stage (``repro_torch.inference``) against the
JAX package's (``repro.inference``), on the CPU at small sizes.

Tolerances (docs/PORT.md): shuffle surrogates are equal; phase
surrogates agree within 1e-5 * max|x| (``torch.fft`` and ``jnp.fft``
round differently); convergence statistics and the BH functions are
equal on equal inputs; p-values are equal wherever no surrogate's null
rho lies within a near-tie tolerance of the observed rho — there a
rounding difference may flip one comparison, and the tests count and
report such pairs instead of comparing them.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ccm as jccm  # noqa: E402
from repro.core.types import EDMConfig as JCfg  # noqa: E402
from repro.inference import significance as jsig  # noqa: E402
from repro.inference import surrogates as jsurr  # noqa: E402
from repro_torch.core import ccm as tccm  # noqa: E402
from repro_torch.core.types import EDMConfig, config_from_jax  # noqa: E402
from repro_torch.inference import prng  # noqa: E402
from repro_torch.inference import significance as tsig  # noqa: E402
from repro_torch.inference import surrogates as tsurr  # noqa: E402
from repro_torch.inference.types import SignificanceConfig, sig_config_from_jax  # noqa: E402

NEAR_TIE = 1e-6  # |null - obs| within which equal inputs may round apart
NEAR_TIE_PHASE = 1e-5  # ... and where phase surrogates themselves differ


def _tcfg(jcfg):
    return config_from_jax(dataclasses.asdict(jcfg))


# ------------------------------------------------------------- surrogates
@pytest.mark.parametrize("L", [301, 400])
def test_surrogates_match_jax(L):
    """Shuffle surrogates equal; phase surrogates within 1e-5 max|x|
    (odd and even L: the Nyquist bin is kept only for even L)."""
    x = np.random.default_rng(L).standard_normal((3, L)).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(2), 3)
    tkeys = prng.split(prng.prng_key(2), 3)
    for kind, gen in (("shuffle", jsurr.random_shuffle),
                      ("phase", jsurr.phase_randomized)):
        want = np.stack([np.asarray(gen(k, jnp.asarray(r), 5))
                         for k, r in zip(jkeys, x)])
        got = tsurr._GENERATORS[kind](tkeys, torch.tensor(x), 5).numpy()
        assert got.shape == (3, 5, L)
        if kind == "shuffle":
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("kind", ["shuffle", "phase"])
def test_surrogate_futures_match_jax_and_blocking_is_invisible(kind):
    """Per-target fold_in on the global id: the port's futures equal the
    JAX ones (phase within 1e-5 max|x|), and building them in blocks of
    targets — the pipeline's once-per-run build — gives the bits of one
    call over every target."""
    cfg = JCfg(E_max=4)
    ts = np.random.default_rng(0).standard_normal((7, 200)).astype(np.float32)
    ids = np.array([6, 2, 0, 5, 1, 3, 4], np.int32)
    want = np.asarray(jsurr.surrogate_futures(
        jax.random.PRNGKey(3), jnp.asarray(ts[ids]), jnp.asarray(ids), n=4,
        kind=kind, cfg=cfg))
    key = prng.prng_key(3)
    tcfg = _tcfg(cfg)
    got = tsurr.surrogate_futures(key, torch.tensor(ts[ids]), torch.tensor(ids),
                                  4, kind, tcfg)
    assert got.shape == want.shape == (7 * 4, 200 - 4)
    if kind == "shuffle":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(ts).max()
    blocks = torch.cat([
        tsurr.surrogate_futures(key, torch.tensor(ts[ids[b:b + 3]]),
                                torch.tensor(ids[b:b + 3]), 4, kind, tcfg)
        for b in range(0, 7, 3)
    ])
    assert torch.equal(blocks, got)


# ----------------------------------------------- statistics and BH-FDR
def test_convergence_stats_equal_jax():
    from repro.inference import convergence_stats as jstats
    from repro_torch.inference import convergence_stats

    rng = np.random.default_rng(1)
    curves = rng.integers(0, 4, (5, 6, 7)).astype(np.float32) / 4  # ties
    curves[:, 0, 0] = [0.1, 0.2, 0.3, 0.4, 0.5]
    jd, jt = jstats(jnp.asarray(curves))
    td, tt = convergence_stats(torch.tensor(curves))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt[0, 0] == 1.0


def test_bh_functions_and_edges_equal_jax():
    rng = np.random.default_rng(2)
    m = 19
    p = ((rng.integers(1, m + 2, (12, 12))) / (m + 1.0)).astype(np.float32)
    p[:3, :3] = 1 / (m + 1.0)
    for alpha in (0.05, 0.2, 1.0):
        assert tsig.bh_threshold(p, alpha) == jsig.bh_threshold(p, alpha)
    counts = np.bincount(np.rint(p.ravel() * (m + 1)).astype(int) - 1,
                         minlength=m + 1)
    for alpha in (0.05, 0.2, 1.0):
        assert tsig.bh_threshold_discrete(counts, m, alpha) == \
            jsig.bh_threshold_discrete(counts, m, alpha)
    np.testing.assert_array_equal(tsig.bh_adjust(p), jsig.bh_adjust(p))
    rho = rng.standard_normal((12, 12)).astype(np.float32)
    d, t = rho * 0.5, np.sign(rho)
    for cut in (0.0, 0.06, 0.5):
        np.testing.assert_array_equal(tsig.assemble_edges(p, rho, d, t, cut),
                                      jsig.assemble_edges(p, rho, d, t, cut))
    with pytest.raises(ValueError, match="counts must have shape"):
        tsig.bh_threshold_discrete(counts[:-1], m, 0.1)


def test_sig_config_from_jax():
    from repro.inference import SignificanceConfig as JSig

    j = JSig(lib_sizes=[50, 100], n_surrogates=9, alpha=0.1, surrogate="shuffle",
             seed=4)
    assert sig_config_from_jax(dataclasses.asdict(j)) == SignificanceConfig(
        lib_sizes=(50, 100), n_surrogates=9, alpha=0.1, surrogate="shuffle", seed=4)
    with pytest.raises(ValueError, match="not in the port"):
        sig_config_from_jax({"workers": 2})
    with pytest.raises(ValueError, match="ascending"):
        SignificanceConfig(lib_sizes=(100, 50))


# ------------------------------------------------------- null p-values
def test_null_block_pvals_on_jax_tables_and_futures(record_property):
    """Fed the JAX-made full-library tables and surrogate futures, the
    port's p-values equal the JAX ones wherever every surrogate's null
    rho is more than 1e-6 from the observed rho."""
    from repro.core.pipeline import run_causal_inference
    from repro.data.synthetic import dummy_brain

    cfg = JCfg(E_max=5)
    ts = dummy_brain(12, 260, seed=1)
    res = run_causal_inference(ts, cfg)
    rho, optE = np.asarray(res.rho), np.asarray(res.optE)
    plan, order = jccm.make_bucket_plan(optE)
    m = 9
    fut = jsurr.surrogate_futures(jax.random.PRNGKey(0), jnp.asarray(ts[order]),
                                  jnp.asarray(order.astype(np.int32)), n=m,
                                  kind="phase", cfg=cfg)
    seg_m = tuple((b, c * m) for b, c in enumerate(plan.counts))
    rho_obs = rho[:, order]

    @jax.jit  # as the JAX pipeline runs it: XLA turns / (m + 1) into a product
    def reference(rows, fut, rho_obs):
        idx, w = jax.vmap(lambda x: jccm.ccm_row_tables_bucketed(x, cfg, plan))(rows)
        null = jax.vmap(lambda i, ww: jccm.ccm_row_lookup_bucketed(
            i, ww, fut, cfg, seg_m))(idx, w)
        return idx, w, null, jsig.null_block_pvals(idx, w, fut, rho_obs, cfg,
                                                   seg_m, m)

    idx, w, null, want = reference(jnp.asarray(ts), fut, jnp.asarray(rho_obs))
    null, want = np.asarray(null).reshape(12, 12, m), np.asarray(want)
    got = tsig.null_block_pvals(
        torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(w)),
        torch.tensor(np.asarray(fut)), torch.tensor(rho_obs), _tcfg(cfg), seg_m, m,
    ).numpy()
    near = (np.abs(null - rho_obs[..., None]) <= NEAR_TIE).any(-1)
    record_property("near_ties_skipped", int(near.sum()))
    print(f"null_block_pvals: {int(near.sum())} of {near.size} pairs are "
          "near-ties, not compared")
    assert near.sum() <= near.size // 4
    np.testing.assert_array_equal(got[~near], want[~near])
    assert set(np.rint(got * (m + 1)).astype(int).ravel()) <= set(range(1, m + 2))


# --------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def sig_system():
    """4 series: x drives y (true edge x -> y); a, b independent — the
    system of tests/test_inference.py, mapped by the JAX package."""
    from repro.core.pipeline import run_causal_inference
    from repro.data.synthetic import coupled_logistic

    x, y = coupled_logistic(600, beta_xy=0.0, beta_yx=0.12, seed=3)
    a, b = coupled_logistic(600, beta_xy=0.0, beta_yx=0.0, seed=12)
    ts = np.stack([x, y, a, b]).astype(np.float32)
    cfg = JCfg(E_max=5)
    res = run_causal_inference(ts, cfg)
    return ts, cfg, np.asarray(res.optE), np.asarray(res.rho)


def _port_curves_and_null(ts, cfg, optE, rho, sig):
    """The port's rho curves (S, N, N) and null rho (N, N, m), natural
    column order, to find the near-ties of a run."""
    from repro_torch.inference import convergence
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    r = SignificanceChunkRunner(ts, optE, cfg, sig, device="cpu")
    inv = np.argsort(r.order)
    cidx, cw = convergence.conv_block_tables(r.rows(0, r.N), cfg, r.plan, sig.lib_sizes,
                                             r.col_ids)
    seg = tuple(enumerate(r.plan.counts))
    curves = torch.stack([
        tccm.ccm_row_lookup_bucketed(cidx[:, s], cw[:, s], r.fut_sorted, cfg, seg)
        for s in range(len(sig.lib_sizes))
    ]).numpy()[..., inv]
    fidx, fw = tccm.ccm_row_tables_bucketed(r.rows(0, r.N), cfg, r.plan)
    m = sig.n_surrogates
    null = tccm.ccm_row_lookup_bucketed(
        fidx, fw, r.fut_surr, cfg, tuple((b, c * m) for b, c in seg)
    ).numpy().reshape(r.N, r.N, m)[:, inv]
    return curves, null


@pytest.mark.parametrize("target_block", [2, 5, 12])
def test_conv_block_tile_folded_sizes_equal_the_per_size_loop(sig_system,
                                                            target_block):
    """conv_block_tile with the S library sizes folded into the lookup's
    table dimension equals the per-size loop of lookups, bit for bit,
    with target blocks that cross segment boundaries."""
    from repro_torch.inference import convergence
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    ts, jcfg, optE, rho = sig_system
    cfg = dataclasses.replace(_tcfg(jcfg), target_block=target_block)
    sig = SignificanceConfig(lib_sizes=(60, 300, 570), n_surrogates=3, seed=0)
    r = SignificanceChunkRunner(ts, optE, cfg, sig, device="cpu")
    cidx, cw = convergence.conv_block_tables(r.rows(0, r.N), cfg, r.plan, sig.lib_sizes,
                                             r.col_ids)
    seg = tuple(enumerate(r.plan.counts))
    drho, trend = convergence.conv_block_tile(cidx, cw, r.fut_sorted, cfg, seg)
    curves = torch.stack([
        tccm.ccm_row_lookup_bucketed(cidx[:, s], cw[:, s], r.fut_sorted, cfg, seg)
        for s in range(len(sig.lib_sizes))
    ])
    want_drho, want_trend = convergence.convergence_stats(curves)
    assert torch.equal(drho, want_drho) and torch.equal(trend, want_trend)


@pytest.mark.parametrize("kind", ["phase", "shuffle"])
def test_run_significance_matches_jax_end_to_end(sig_system, kind, record_property):
    from repro.inference import SignificanceConfig as JSig
    from repro.inference import run_significance as jrun
    from repro_torch.inference import run_significance

    ts, jcfg, optE, rho = sig_system
    jsig_cfg = JSig(lib_sizes=(60, 300, 570), n_surrogates=39, alpha=0.5, seed=0,
                    surrogate=kind)
    cfg, sig = _tcfg(jcfg), sig_config_from_jax(dataclasses.asdict(jsig_cfg))
    want = jrun(ts, optE, rho, jcfg, jsig_cfg)
    got = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    assert got.n_tests == want.n_tests == 12
    assert np.abs(got.drho - want.drho).max() <= 1e-5

    curves, null = _port_curves_and_null(ts, cfg, optE, rho, sig)
    gaps = np.abs(curves[:, None] - curves[None, :])
    S = curves.shape[0]
    trend_tie = (gaps[np.triu_indices(S, 1)] <= NEAR_TIE).any(0)
    tol = NEAR_TIE_PHASE if kind == "phase" else NEAR_TIE
    p_tie = (np.abs(null - rho[..., None]) <= tol).any(-1)
    record_property("near_ties_skipped", int(trend_tie.sum() + p_tie.sum()))
    print(f"{kind}: near-ties not compared: trend {int(trend_tie.sum())}, "
          f"p-values {int(p_tie.sum())} of {p_tie.size}")
    np.testing.assert_array_equal(got.trend[~trend_tie], want.trend[~trend_tie])
    np.testing.assert_array_equal(got.pvals[~p_tie], want.pvals[~p_tie])

    def pairs(edges):
        return {(int(e["src"]), int(e["dst"])) for e in edges}

    assert (0, 1) in pairs(got.edges) and (0, 1) in pairs(want.edges)
    # edges: the same wherever no near-tie touches the p-value map
    if not p_tie[~np.eye(4, dtype=bool)].any():
        assert pairs(got.edges) == pairs(want.edges)
        assert got.p_threshold == want.p_threshold


@pytest.mark.parametrize("grid", [None, 4])
def test_significance_at_exclude_self_false_matches_jax_off_near_ties(
        grid, record_property):
    """The stage with the query point kept among its own neighbours
    (``exclude_self=False``), against JAX, at N 9 x L 131, E_max 6 and 6
    surrogates.  A point's own future then carries its forecast, so the
    observed rho lies within one ulp of 1.0 and the null's ``>= obs`` may
    round either way: those p-values are counted and reported, not
    compared.  On the raw series every rho is such a near-tie; with the
    values on a grid of 1/4 (``grid``), repeated points share their
    futures and most rho fall below 1.0.  Every other p-value is equal,
    and drho is within 1e-5."""
    from repro.core.pipeline import run_causal_inference as jax_map
    from repro.data.synthetic import dummy_brain
    from repro.inference import SignificanceConfig as JSig
    from repro.inference import run_significance as jrun
    from repro_torch.inference import run_significance

    ts = dummy_brain(9, 131, seed=0)
    if grid is not None:
        ts = (np.round(ts * grid) / grid).astype(np.float32)
    jcfg = JCfg(E_max=6, exclude_self=False)
    jres = jax_map(ts, jcfg)
    optE, rho = np.asarray(jres.optE), np.asarray(jres.rho)
    jsig_cfg = JSig(lib_sizes=(20, 60, 125), n_surrogates=6, alpha=0.5, seed=0,
                    surrogate="shuffle")
    cfg, sig = _tcfg(jcfg), sig_config_from_jax(dataclasses.asdict(jsig_cfg))
    assert cfg.exclude_self is False
    want = jrun(ts, optE, rho, jcfg, jsig_cfg)
    got = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    assert np.abs(got.drho - np.asarray(want.drho)).max() <= 1e-5
    near_one = np.abs(rho.astype(np.float64) - 1.0) <= np.spacing(np.float32(1.0))
    differ = got.pvals != np.asarray(want.pvals)
    record_property("near_ties_skipped", int(near_one.sum()))
    print(f"exclude_self=False, grid {grid}: {int(near_one.sum())} of "
          f"{near_one.size} observed rho within 1 ulp of 1.0 (not compared), "
          f"{int(differ[near_one].sum())} of their p-values differ")
    if grid is not None:
        assert (~near_one).sum() >= near_one.size // 2
    np.testing.assert_array_equal(got.pvals[~near_one],
                                  np.asarray(want.pvals)[~near_one])


def test_tiled_significance_matches_jax_untiled(sig_system):
    """The tiled stage (tile 3 of 4 targets) against JAX's untiled stage,
    with the tolerances of the untiled comparison."""
    from repro.inference import SignificanceConfig as JSig
    from repro.inference import run_significance as jrun
    from repro_torch.inference import run_significance

    ts, jcfg, optE, rho = sig_system
    jsig_cfg = JSig(lib_sizes=(60, 300, 570), n_surrogates=19, alpha=0.5, seed=0,
                    surrogate="shuffle")
    cfg = dataclasses.replace(_tcfg(jcfg), target_tile=3)
    sig = sig_config_from_jax(dataclasses.asdict(jsig_cfg))
    want = jrun(ts, optE, rho, jcfg, jsig_cfg)
    got = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    assert np.abs(got.drho - want.drho).max() <= 1e-5
    curves, null = _port_curves_and_null(ts, _tcfg(jcfg), optE, rho, sig)
    S = curves.shape[0]
    gaps = np.abs(curves[:, None] - curves[None, :])
    trend_tie = (gaps[np.triu_indices(S, 1)] <= NEAR_TIE).any(0)
    p_tie = (np.abs(null - rho[..., None]) <= NEAR_TIE).any(-1)
    np.testing.assert_array_equal(got.trend[~trend_tie], want.trend[~trend_tie])
    np.testing.assert_array_equal(got.pvals[~p_tie], want.pvals[~p_tie])


@pytest.fixture(scope="module")
def sig_map():
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.data.synthetic import dummy_brain

    ts = dummy_brain(13, 300, seed=2)
    cfg = EDMConfig(E_max=4, lib_block=3)
    cmap = run_causal_inference(ts, cfg, device="cpu")
    sig = SignificanceConfig(lib_sizes=(40, 120, 290), n_surrogates=7, alpha=0.4,
                             seed=1)
    return ts, cfg, cmap.optE, cmap.rho, sig


@pytest.mark.parametrize("tile", [1, 3, 5, 13])
def test_tiled_significance_equals_untiled_bytes(sig_map, tile, monkeypatch):
    """At every tile width drho, trend, p-values and edges equal the
    untiled stage's byte for byte, and the largest surrogate tensor the
    tiled stage builds is one tile's T * m rows: no (N * m, Lp) tensor."""
    from repro_torch.inference import pipeline as ipipe
    from repro_torch.inference import run_significance

    ts, cfg, optE, rho, sig = sig_map
    base = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    tiled = dataclasses.replace(cfg, target_tile=tile)
    built = []
    surrogates = ipipe.SignificanceChunkRunner.surrogates

    def spy(self, c0, c1, dev=None):
        out = surrogates(self, c0, c1, dev)
        built.append(out.shape[0])
        return out

    monkeypatch.setattr(ipipe.SignificanceChunkRunner, "surrogates", spy)
    r = ipipe.SignificanceChunkRunner(ts, optE, tiled, sig, device="cpu")
    assert r.T == tile and r.fut_surr is None and r.fut_sorted is None
    got = run_significance(ts, optE, rho, tiled, sig, device="cpu")
    m, N = sig.n_surrogates, ts.shape[0]
    assert max(built) == min(tile, N) * m
    assert len(built) == -(-N // cfg.lib_block) * -(-N // tile)
    for a in ("drho", "trend", "pvals"):
        np.testing.assert_array_equal(getattr(got, a), getattr(base, a), err_msg=a)
    np.testing.assert_array_equal(got.edges, base.edges)
    assert (got.p_threshold, got.n_tests) == (base.p_threshold, base.n_tests)


def test_tiled_significance_store_resumes_to_the_untiled_bytes(sig_map, tmp_path):
    from repro_torch.inference import run_significance

    ts, cfg, optE, rho, sig = sig_map
    mem = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    tiled = dataclasses.replace(cfg, target_tile=4)
    disk = run_significance(ts, optE, rho, tiled, sig, device="cpu",
                            out_dir=str(tmp_path))
    np.testing.assert_array_equal(np.asarray(disk.pvals), mem.pvals)
    np.testing.assert_array_equal(np.asarray(disk.drho), mem.drho)
    from repro_torch.runtime.integrity import manifest_with_crc

    for a in ("rho_conv", "rho_trend", "pvals"):
        man = json.loads((tmp_path / a / "blocks.json").read_text())
        man.pop("__crc__")
        assert "3,4" in man and len(man) == 5 * 4
        man.pop("3,4")
        (tmp_path / a / "tile_00000003_00000004.npy").unlink()
        (tmp_path / a / "blocks.json").write_text(manifest_with_crc(man))
    again = run_significance(ts, optE, rho, dataclasses.replace(cfg, target_tile=6),
                             sig, device="cpu", out_dir=str(tmp_path))
    np.testing.assert_array_equal(np.asarray(again.pvals), mem.pvals)
    np.testing.assert_array_equal(np.asarray(again.trend), mem.trend)
    np.testing.assert_array_equal(again.edges, mem.edges)


def test_ccm_convergence_pair_matches_jax(coupled_pair):
    from repro.inference import ccm_convergence_pair as jpair
    from repro_torch.inference import ccm_convergence_pair

    x, y = coupled_pair
    cfg = JCfg(E_max=4)
    jitted = jax.jit(jpair, static_argnums=(2, 3, 4))
    want = np.asarray(jitted(jnp.asarray(y), jnp.asarray(x), 3, (40, 150, 700),
                             cfg, jax.random.PRNGKey(0)))
    got = ccm_convergence_pair(torch.tensor(y), torch.tensor(x), 3, (40, 150, 700),
                               _tcfg(cfg), prng.prng_key(0)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert got[-1] > got[0]


# ------------------------------------------------------------- the store
def test_store_equals_memory_resumes_and_seeds(sig_system, tmp_path):
    from repro_torch.inference import run_significance

    ts, jcfg, optE, rho = sig_system
    cfg = dataclasses.replace(_tcfg(jcfg), lib_block=3)  # chunks 3 + 1
    sig = SignificanceConfig(lib_sizes=(60, 300, 570), n_surrogates=39, alpha=0.2,
                             seed=1)
    mem = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    disk = run_significance(ts, optE, rho, cfg, sig, device="cpu",
                            out_dir=str(tmp_path))
    for a in ("rho_conv", "rho_trend", "pvals", "edges"):
        assert (tmp_path / a / "data.npy").exists()
        assert (tmp_path / a / "meta.json").exists()
    assert json.loads((tmp_path / "edges" / "meta.json").read_text())["seed"] == 1
    np.testing.assert_array_equal(np.asarray(disk.pvals), mem.pvals)
    np.testing.assert_array_equal(np.asarray(disk.drho), mem.drho)
    np.testing.assert_array_equal(np.asarray(disk.trend), mem.trend)
    np.testing.assert_array_equal(disk.edges, mem.edges)
    blobs = {a: (tmp_path / a / "data.npy").read_bytes()
             for a in ("rho_conv", "rho_trend", "pvals", "edges")}

    # drop the last chunk's tiles: the resume recomputes that chunk only
    # (the recount path) and reproduces every byte
    for a in ("rho_conv", "rho_trend", "pvals"):
        man = json.loads((tmp_path / a / "blocks.json").read_text())
        man.pop("__crc__")
        assert sorted(man) == ["0,0", "3,0"]
        man.pop("3,0")
        (tmp_path / a / "tile_00000003_00000000.npy").unlink()
        from repro_torch.runtime.integrity import manifest_with_crc

        (tmp_path / a / "blocks.json").write_text(manifest_with_crc(man))
    again = run_significance(ts, optE, rho, cfg, sig, device="cpu",
                             out_dir=str(tmp_path))
    assert again.p_threshold == mem.p_threshold
    for a, b in blobs.items():
        assert (tmp_path / a / "data.npy").read_bytes() == b, a

    with pytest.raises(ValueError, match="resume config mismatch"):
        run_significance(ts, optE, rho, cfg, dataclasses.replace(sig, seed=2),
                         device="cpu", out_dir=str(tmp_path))
    same = run_significance(ts, optE, rho, cfg, sig, device="cpu")
    np.testing.assert_array_equal(same.pvals, mem.pvals)
    other = run_significance(ts, optE, rho, cfg, dataclasses.replace(sig, seed=0),
                             device="cpu")
    assert not np.array_equal(other.pvals, mem.pvals)


def test_fsck_reads_a_port_significance_store_as_a_jax_one(sig_system, tmp_path):
    """``repro``'s fsck over a JAX in-process significance store (checked
    first) and over the port's: the same artifacts, every one clean."""
    from repro.core.pipeline import run_causal_inference as jmap
    from repro.inference import SignificanceConfig as JSig
    from repro.inference import run_significance as jrun
    from repro.runtime.integrity import fsck_store
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.inference import run_significance

    ts, jcfg, _, _ = sig_system
    jsig_cfg = JSig(lib_sizes=(60, 570), n_surrogates=9, alpha=0.5, seed=0)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jres = jmap(ts, jcfg, out_dir=str(jout))
    jrun(ts, np.asarray(jres.optE), np.asarray(jres.rho), jcfg, jsig_cfg,
         out_dir=str(jout))
    jrep = fsck_store(jout)
    assert jrep["clean"], jrep

    cfg = _tcfg(jcfg)
    tres = run_causal_inference(ts, cfg, device="cpu", out_dir=str(tout))
    run_significance(ts, tres.optE, tres.rho, cfg,
                     sig_config_from_jax(dataclasses.asdict(jsig_cfg)),
                     device="cpu", out_dir=str(tout))
    trep = fsck_store(tout)
    assert trep["clean"], trep
    assert sorted(trep["artifacts"]) == sorted(jrep["artifacts"])
    for name, a in jrep["artifacts"].items():
        b = trep["artifacts"][name]
        if "status" in a:
            assert b["status"] == a["status"], name
        else:
            assert b["ok"] == a["ok"] and not b["corrupt"] and not b["missing"], name


def test_phase2_refuses_a_store_of_column_tiles(tmp_path):
    """The tiled phase 2 resumes a store of column tiles only in the
    column order they were written in: natural-order tiles, or tiles
    under another permutation, are refused before any is written."""
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.data.store import TileWriter

    ts = np.random.default_rng(0).standard_normal((4, 120)).astype(np.float32)
    cfg = EDMConfig(E_max=3, target_tile=2)
    w = TileWriter(tmp_path / "natural", 4)
    w.write_tile(0, 0, np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="natural-order tiles"):
        run_causal_inference(ts, cfg, device="cpu", out_dir=str(tmp_path / "natural"))
    w = TileWriter(tmp_path / "permuted", 4)
    w.ensure_col_order(np.array([3, 2, 1, 0]))
    w.write_tile(0, 0, np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="column-order mismatch"):
        run_causal_inference(ts, cfg, device="cpu", out_dir=str(tmp_path / "permuted"))
    assert sorted(p.name for p in (tmp_path / "permuted").glob("tile_*")) == [
        "tile_00000000_00000000.npy"]


# ------------------------------------------------------------------ the CLI
def test_cli_significance_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import edm_run

    out = tmp_path / "o"
    summary = edm_run.main([
        "--synthetic", "12x300", "--e-max", "4", "--lib-block", "5",
        "--lib-sizes", "50,100,200", "--surrogates", "5", "--fdr", "0.5",
        "--surrogate-kind", "shuffle", "--seed", "3", "--device", "cpu",
        "--out", str(out)])
    for a in ("causal_map", "rho_conv", "rho_trend", "pvals", "edges"):
        assert (out / a / "data.npy").exists(), a
    meta = json.loads((out / "causal_map" / "meta.json").read_text())
    assert meta["seed"] == 3
    assert summary["edges"] == len(np.load(out / "edges" / "data.npy"))
    assert summary["significance_s"] > 0
    text = capsys.readouterr().out
    assert "significance [convergence+surrogates] in" in text
    assert "edges at FDR 0.5" in text
    p = np.load(out / "pvals" / "data.npy")
    assert set(np.rint(p * 6).astype(int).ravel()) <= set(range(1, 7))
