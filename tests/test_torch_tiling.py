"""The port's tiled and all-E phase 2 on the CPU: every (target_tile,
bucketed) layout against the JAX package's untiled map, tiled == untiled
byte for byte inside the port (the port is never held to the JAX tiled
bytes, which differ from its own untiled ones), the tiled store and its
resume, the store's tile coverage, the CLI flags, the cuda engine's
limits and the bfloat16 accumulator."""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ccm as jccm  # noqa: E402
from repro.core import simplex as jsimplex  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.data.synthetic import dummy_brain  # noqa: E402
from repro_torch.core import ccm as tccm  # noqa: E402
from repro_torch.core import simplex as tsimplex  # noqa: E402
from repro_torch.core.pipeline import run_causal_inference  # noqa: E402
from repro_torch.core.types import EDMConfig, config_from_jax  # noqa: E402
from repro_torch.data.store import TileWriter  # noqa: E402
from repro_torch.runtime.integrity import manifest_with_crc  # noqa: E402

TOL = 1e-5
N, L, E_MAX = 14, 250, 5


@pytest.fixture(scope="module")
def maps():
    """JAX's untiled maps (both layouts), the port's optE and its untiled
    maps, at N = 14 (tiles 3 and 5 do not divide it)."""
    ts = dummy_brain(N, L, seed=21)
    jcfg = JaxConfig(E_max=E_MAX)
    _, j_optE = jsimplex.simplex_batch(jnp.asarray(ts), jcfg)
    j_optE = np.asarray(j_optE)
    _, t_optE = tsimplex.simplex_batch(torch.tensor(ts), config_from_jax(
        dataclasses.asdict(jcfg)))
    out = {"ts": ts, "optE": j_optE, "port_optE": t_optE.numpy()}
    for bucketed in (True, False):
        jc = JaxConfig(E_max=E_MAX, bucketed=bucketed)
        out["jax", bucketed] = np.asarray(
            jccm.ccm_matrix(jnp.asarray(ts), jnp.asarray(j_optE), jc))
        out["port", bucketed] = tccm.ccm_matrix(
            torch.tensor(ts), j_optE, _cfg(bucketed=bucketed)).numpy()
    return out


def _cfg(**kw):
    return dataclasses.replace(
        config_from_jax(dataclasses.asdict(JaxConfig(E_max=E_MAX, lib_block=4))),
        **kw)


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("tile", [1, 3, 5, 14, 56])
def test_tiled_map_matches_jax_untiled_and_own_untiled_bytes(maps, tile, bucketed):
    assert np.array_equal(maps["port_optE"], maps["optE"])
    got = tccm.ccm_matrix(torch.tensor(maps["ts"]), maps["optE"],
                          _cfg(bucketed=bucketed, target_tile=tile)).numpy()
    assert got.shape == (N, N) and np.isfinite(got).all()
    assert np.abs(got - maps["jax", bucketed]).max() <= TOL
    np.testing.assert_array_equal(got, maps["port", bucketed])


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("target_block,tile", [(7, 3), (24, 5), (24, 11), (24, 40)])
def test_blocks_past_16_targets_keep_the_untiled_bytes(bucketed, target_block, tile):
    """At N = 40 blocks of 24 targets hold more than 16 of them, so a
    tile's pieces take the padded Pearson layout; bytes still equal the
    untiled map's at that target_block, and the untiled maps at every
    target_block agree within TOL of each other."""
    ts = torch.tensor(dummy_brain(40, 200, seed=4))
    cfg = EDMConfig(E_max=4, lib_block=16, bucketed=bucketed,
                    target_block=target_block)
    _, optE = tsimplex.simplex_batch(ts, cfg)
    base = tccm.ccm_matrix(ts, optE.numpy(), cfg)
    got = tccm.ccm_matrix(ts, optE.numpy(), dataclasses.replace(cfg, target_tile=tile))
    assert torch.equal(got, base)
    wide = tccm.ccm_matrix(ts, optE.numpy(), dataclasses.replace(cfg, target_block=2048))
    assert (got - wide).abs().max() <= TOL


def test_all_e_row_lookup_matches_jax_per_target_lookup(maps):
    """The all-E lookup sorts each target block by table row and runs the
    segmented lookup; the JAX reference looks each target up through its
    own table.  Same rho within TOL at target blocks that cut the
    targets at several places, for one library series too."""
    ts = maps["ts"]
    jcfg = JaxConfig(E_max=E_MAX, target_block=4)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    fut = tccm.all_futures(torch.tensor(ts), cfg)
    idx, w = tccm.ccm_row_tables(torch.tensor(ts[:3]), cfg)
    assert idx.shape == (3, E_MAX, fut.shape[1], E_MAX + 1)
    e_idx = maps["optE"] - 1
    got = tccm.ccm_row_lookup(idx, w, fut, e_idx, cfg)
    want = np.stack([np.asarray(jccm.ccm_row_lookup(
        jnp.asarray(idx[s].numpy()), jnp.asarray(w[s].numpy()),
        jnp.asarray(fut.numpy()), jnp.asarray(e_idx), jcfg)) for s in range(3)])
    assert np.abs(got.numpy() - want).max() <= TOL
    row = tccm.ccm_library_row(torch.tensor(ts[1]), fut, maps["optE"], cfg)
    want_row = np.asarray(jccm.ccm_library_row(
        jnp.asarray(ts[1]), jnp.asarray(fut.numpy()), jnp.asarray(maps["optE"]), jcfg))
    assert np.abs(row.numpy() - want_row).max() <= TOL


def test_target_blocks_follow_the_global_grid():
    # a tile at columns [5, 13) of 20 with blocks of 4: pieces [5, 8),
    # [8, 12), [12, 13) of the untiled blocks
    segs = ((0, 2), (1, 6))
    assert tccm.target_blocks(segs, 4, 5, 20) == (
        (0, 3, ((0, 2), (1, 1))), (3, 7, ((1, 4),)), (7, 8, ((1, 1),)))
    assert tccm.target_blocks(segs, 4) == tccm.target_blocks(segs, 4, 0, 8)


@pytest.mark.parametrize("col0,n,block,want", [
    (0, 2048, 2048, (0, 2048)),    # a full untiled block
    (512, 512, 2048, (0, 512)),    # 512 at offset 512: alignment 0 mod 4
    (513, 100, 2048, (1, 104)),    # offset 1 mod 4, rows a multiple of 4
    (3, 5, 2048, (3, 16)),         # a short block: at least 16 rows
    (17, 2, 24, (1, 16)),          # offset 17 in its cell of 24
    (0, 10, 2048, (0, 16)),        # an untiled block of 10 is padded too
    (0, 2050, 4096, (0, 2052)),    # ... and one of 2050 to a multiple of 4
])
def test_pearson_layout(col0, n, block, want):
    """Every row of the buffer sits at its target's alignment in its grid
    cell (pad = offset mod 4, rows a multiple of 4, so the (S, rows, Lq)
    buffer keeps it for every library row s) and the buffer has at least
    16 rows, whatever the chunk size S."""
    pad, rows = tccm.pearson_layout(col0, n, block)
    assert pad + n <= rows
    assert (pad - col0 % block) % 4 == 0 and rows % 4 == 0
    assert rows >= 16
    assert (pad, rows) == want


# ------------------------------------------------------ pipeline and store
@pytest.mark.parametrize("bucketed", [True, False])
def test_tiled_pipeline_with_store_equals_untiled(tmp_path, bucketed):
    ts = dummy_brain(13, 230, seed=3)
    base = run_causal_inference(ts, EDMConfig(E_max=4, lib_block=3, bucketed=bucketed),
                                device="cpu")
    out = tmp_path / "store"
    res = run_causal_inference(
        ts, EDMConfig(E_max=4, lib_block=3, bucketed=bucketed, target_tile=5),
        device="cpu", out_dir=str(out))
    assert isinstance(res.rho, np.memmap)
    np.testing.assert_array_equal(np.asarray(res.rho), base.rho)
    assert (out / "col_order.npy").exists() == bucketed
    assert len(list(out.glob("tile_*.npy"))) == 5 * 3
    in_mem = run_causal_inference(
        ts, EDMConfig(E_max=4, lib_block=3, bucketed=bucketed, target_tile=4),
        device="cpu")
    np.testing.assert_array_equal(in_mem.rho, base.rho)


def _drop(out, key, fname):
    man = json.loads((out / "blocks.json").read_text())
    man.pop("__crc__")
    man.pop(key)
    (out / "blocks.json").write_text(manifest_with_crc(man))
    (out / fname).unlink()


@pytest.mark.parametrize("bucketed", [True, False])
def test_tiled_resume_at_other_geometry_recomputes_only_uncovered_rows(
        tmp_path, capsys, bucketed):
    from repro_torch.launch import edm_run

    out = tmp_path / "s"
    flags = ["--synthetic", "13x230", "--e-max", "4", "--device", "cpu",
             "--out", str(out)] + ([] if bucketed else ["--no-bucketed"])
    edm_run.main(flags + ["--target-tile", "5", "--lib-block", "3"])
    before = (out / "causal_map" / "data.npy").read_bytes()
    _drop(out, "6,5", "tile_00000006_00000005.npy")
    (out / "causal_map" / "data.npy").unlink()
    capsys.readouterr()
    edm_run.main(flags + ["--target-tile", "4", "--lib-block", "2"])
    log = capsys.readouterr().out
    assert "ccm rows 6..8 / 13" in log and "ccm rows 8..9 / 13" in log
    assert "ccm rows 0.." not in log and "ccm rows 9.." not in log
    assert (out / "causal_map" / "data.npy").read_bytes() == before
    # the untiled path resumes the tiled store too: nothing left to do
    capsys.readouterr()
    edm_run.main(flags + ["--lib-block", "5"])
    assert "ccm rows" not in capsys.readouterr().out
    assert (out / "causal_map" / "data.npy").read_bytes() == before


def test_tile_writer_roundtrip_and_block_interop(tmp_path):
    n = 9
    rho = np.arange(n * n, dtype=np.float32).reshape(n, n)
    w = TileWriter(tmp_path / "w", n)
    w.write_tile(0, 0, rho[:4, :5])
    w.write_tile(0, 5, rho[:4, 5:])
    w.write_block(4, rho[4:])
    assert w.covered().all()
    np.testing.assert_array_equal(w.assemble(), rho)
    w2 = TileWriter(tmp_path / "w", n)
    assert w2.chunk_plan(4) == []
    mm = w2.assemble(mmap_path=tmp_path / "w" / "causal_map" / "data.npy")
    assert isinstance(mm, np.memmap)
    np.testing.assert_array_equal(np.asarray(mm), rho)


def test_tile_writer_partial_tiles_cover_nothing(tmp_path):
    w = TileWriter(tmp_path / "w", 6)
    w.write_tile(0, 0, np.ones((6, 4), np.float32))
    assert not w.covered().any()
    assert w.chunk_plan(4) == [(0, 4), (4, 2)]
    w.write_tile(0, 4, np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(w.covered(), [True] * 3 + [False] * 3)


def test_tile_writer_union_across_tile_geometries(tmp_path):
    """Tiles of two runs with other tile widths and chunk heights cover
    a row once their column intervals union to the full width."""
    w = TileWriter(tmp_path / "w", 10)
    w.write_tile(0, 0, np.ones((4, 6), np.float32))   # run 1: tile 6, chunk 4
    w.write_tile(0, 6, np.ones((2, 4), np.float32))   # run 1 died mid-chunk
    w.write_tile(2, 5, np.ones((3, 5), np.float32))   # run 2: tile 5, chunk 3
    w.write_tile(5, 0, np.ones((3, 5), np.float32))
    np.testing.assert_array_equal(
        w.covered(), [True, True, True, True] + [False] * 6)
    assert w.chunk_plan(3) == [(4, 3), (7, 3)]


def test_tile_writer_col_order(tmp_path):
    n = 8
    rng = np.random.default_rng(0)
    rho = rng.standard_normal((n, n)).astype(np.float32)
    order = rng.permutation(n)
    w = TileWriter(tmp_path / "w", n)
    w.ensure_col_order(order)
    w.write_tile(0, 0, rho[:, order][:, :5])
    w.write_tile(0, 5, rho[:, order][:, 5:])
    np.testing.assert_array_equal(w.assemble(), rho)
    TileWriter(tmp_path / "w", n).ensure_col_order(order)
    with pytest.raises(ValueError, match="column-order mismatch"):
        TileWriter(tmp_path / "w", n).ensure_col_order(np.roll(order, 1))
    with pytest.raises(ValueError, match="column-order mismatch"):
        TileWriter(tmp_path / "w", n).ensure_col_order(None)
    nat = TileWriter(tmp_path / "nat", n)
    nat.ensure_col_order(None)  # natural order writes no file
    assert not (tmp_path / "nat" / "col_order.npy").exists()
    nat.write_tile(0, 0, rho)
    with pytest.raises(ValueError, match="natural-order tiles"):
        TileWriter(tmp_path / "nat", n).ensure_col_order(order)


# ------------------------------------------------------------------ the CLI
@pytest.mark.parametrize("extra", [["--target-tile", "5"], ["--no-bucketed"],
                                   ["--target-tile", "5", "--no-bucketed"]])
def test_cli_tile_and_all_e_flags_match_the_jax_cli(tmp_path, monkeypatch, extra):
    from repro.launch import edm_run as jcli
    from repro_torch.launch import edm_run

    data = ["--synthetic", "16x300", "--e-max", "4", "--lib-block", "3"]
    summary = edm_run.main(data + extra + ["--device", "cpu",
                                           "--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["edm_run", *data, *extra, "--no-telemetry",
                                      "--out", str(tmp_path / "jax")])
    jcli.main()
    got = np.load(tmp_path / "port" / "causal_map" / "data.npy")
    want = np.load(tmp_path / "jax" / "causal_map" / "data.npy")
    assert np.abs(got - want).max() <= TOL
    meta = json.loads((tmp_path / "port" / "causal_map" / "meta.json").read_text())
    jmeta = json.loads((tmp_path / "jax" / "causal_map" / "meta.json").read_text())
    assert meta["optE"] == jmeta["optE"]
    assert meta["target_tile"] == (5 if "--target-tile" in extra else 0)
    assert meta["bucketed"] == ("--no-bucketed" not in extra)
    assert summary["result"].rho.shape == (16, 16)


# ------------------------------------------------------ the kernels' limits
@pytest.mark.parametrize("kw", [{"E_max": 128}, {"E_max": 20, "k_override": 129},
                                {"E_max": 300}])
def test_cuda_engine_refuses_past_the_kernel_limits_before_any_work(kw):
    """The configs the ``cuda`` engine once refused (tables past 128
    neighbours) are refused no longer: the card takes any config the CPU
    takes.  ``check_limits`` passes them for every device, and the entry
    points raise no limit: without a card they get as far as looking for
    it; on the CPU the k 129 config runs through both."""
    from repro_torch import engine
    from repro_torch.inference import SignificanceConfig, run_significance

    cfg = EDMConfig(**kw)
    assert cfg.k_max > 128
    for name in ("cuda", "torch-reference"):
        for dev in (None, "cuda", torch.device("cuda", 0), "cpu"):
            engine.get_engine(name).check_limits(cfg, dev)
    sig = SignificanceConfig(lib_sizes=(cfg.k_max + 1,), n_surrogates=3)
    if not torch.cuda.is_available():
        ts = np.zeros((4, 100), np.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_causal_inference(ts, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_significance(ts, np.ones(4, np.int32), np.zeros((4, 4), np.float32),
                             cfg, sig)
    if "k_override" in kw:  # L 300: 280 points, 140 a phase-1 half
        ts = dummy_brain(4, 300, seed=2)
        res = run_causal_inference(ts, cfg, device="cpu")
        assert res.rho.shape == (4, 4) and np.isfinite(res.rho).all()
        out = run_significance(ts, res.optE, res.rho, cfg, sig, device="cpu")
        assert np.isfinite(out.drho).all() and np.isfinite(out.pvals).all()
    EDMConfig(**kw)  # the config itself stays as permissive as the reference's
    assert EDMConfig(E_max=127).k_max == 128


# ---------------------------------------------------------------- bfloat16
@pytest.mark.parametrize("bucketed", [True, False])
def test_bf16_maps_tiled_equal_untiled(bucketed):
    ts = dummy_brain(12, 260, seed=8)
    cfg = EDMConfig(E_max=5, lib_block=5, bucketed=bucketed, dist_dtype="bfloat16")
    base = run_causal_inference(ts, cfg, device="cpu")
    for tile in (1, 5, 12):
        got = run_causal_inference(ts, dataclasses.replace(cfg, target_tile=tile),
                                   device="cpu")
        np.testing.assert_array_equal(got.rho, base.rho)
        np.testing.assert_array_equal(got.optE, base.optE)
    f32 = run_causal_inference(ts, dataclasses.replace(cfg, dist_dtype="float32"),
                               device="cpu")
    assert np.isfinite(base.rho).all()
    # bf16 distances reorder near neighbours: close to the f32 map, not equal
    assert 0 < np.abs(base.rho - f32.rho).max() < 0.2
