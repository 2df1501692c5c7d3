"""The port's dataset shapes, its H100 roofline and its dry run.

The datasets equal the JAX package's field for field; the roofline's
peaks are the H100 SXM data sheet's; the per-kernel bounds that
``chip_smoke.py`` once defined itself give its former numbers (computed
with its own copies before they moved, at its own shapes); and a dry run
of a tiny dataset on the CPU gives the JSON of the JAX dry run."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.configs import edm_datasets as jds  # noqa: E402
from repro_torch.configs import edm_datasets as tds  # noqa: E402
from repro_torch.core import ccm  # noqa: E402
from repro_torch.core.types import EDMConfig, config_from_jax  # noqa: E402
from repro_torch.launch import edm_dryrun  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402


def test_datasets_equal_jax_field_for_field():
    assert list(tds.DATASETS) == list(jds.DATASETS)
    for name, j in jds.DATASETS.items():
        t = tds.DATASETS[name]
        assert (t.name, t.n_time_steps, t.n_time_series) == (
            j.name, j.n_time_steps, j.n_time_series)
        # every EDM field equal; the engine is each package's default (the
        # JAX reference engine, the port's cuda engine)
        want = dataclasses.replace(config_from_jax(dataclasses.asdict(j.edm)),
                                   engine=EDMConfig().engine)
        assert t.edm == want
    assert [f.name for f in dataclasses.fields(tds.EDMDatasetConfig)] == [
        f.name for f in dataclasses.fields(jds.EDMDatasetConfig)]
    assert (tds.SUBJECT11.n_time_series, tds.SUBJECT11.n_time_steps) == (101729, 8528)


def test_roofline_constants_are_the_h100s():
    assert RL.PEAK_FP32_FLOPS == 67e12
    assert RL.PEAK_BF16_FLOPS == 989e12
    assert RL.HBM_BYTES_PER_S == 3.35e12
    rl = RL.Roofline(67e12, 3.35e12 / 2)
    assert (rl.t_compute, rl.t_memory, rl.bottleneck, rl.roofline_fraction) == (
        1.0, 0.5, "compute", 1.0)
    rl = RL.Roofline(989e12, 3.35e12, RL.PEAK_BF16_FLOPS)
    assert rl.t_compute == 1.0 and rl.bottleneck == "compute"
    assert not any(k.startswith("t_coll") for k in rl.to_dict())


# (the function chip_smoke.py defined, arguments, the value it returned)
FORMER = [
    ("knn_bound_ms", (8, 20, 20, 1430, 1430, 21), (0.014650029850746269, "operations")),
    ("knn_bound_ms", (8, 12, 4, 1430, 1430, 13), (0.008790017910447761, "operations")),
    ("knn_bound_ms", (8, 20, 20, 715, 715, 21), (0.006010268656716417, "bytes")),
    ("knn_bound_ms", (1, 20, 20, 8508, 8508, 21), (0.0648233408955224, "operations")),
    ("lookup_bound_ms", (8, 2048, 1430, 1430, 21), (0.03204565970149254, "bytes")),
    ("lookup_bound_ms", (1, 2048, 1430, 1430, 21), (0.007065480597014926, "bytes")),
    ("lookup_bound_ms", (8, 2048, 8508, 8508, 21), (0.1906604704477612, "bytes")),
    ("prefix_bound_ms", (8, 12, 4, 1430, 1430, 5, 13), (0.008790017910447761, "operations")),
    ("flash_bound_ms", (4, 2048, 2048, 16, 2, 128, 2), (0.06951772615571283, "operations")),
]


#: chip_smoke.py's former bound -> (the counts that replace it, their peak)
COUNTS = {
    "knn_bound_ms": (RL.knn_counts, RL.PEAK_FP32_FLOPS),
    "lookup_bound_ms": (RL.lookup_counts, RL.PEAK_FP32_FLOPS),
    "prefix_bound_ms": (RL.prefix_counts, RL.PEAK_FP32_FLOPS),
    "flash_bound_ms": (RL.flash_counts, RL.PEAK_BF16_FLOPS),
}


@pytest.mark.parametrize("fn,args,want", FORMER)
def test_moved_bounds_give_chip_smokes_former_numbers(fn, args, want):
    counts, peak = COUNTS[fn]
    assert RL.bound_ms(*counts(*args), peak) == want


def test_moved_segmented_bound_gives_chip_smokes_former_number():
    blocks = ccm.target_blocks(tuple(enumerate((3000, 5000, 7000, 1384))), 2048)
    assert RL.bound_ms(*RL.segmented_counts(8, blocks, 1430, 1430, 13)) == (
        0.2556822925373134, "bytes")


def test_chip_smoke_defines_no_bound_or_peak_of_its_own():
    import pathlib

    text = (pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert "def knn_bound_ms" not in text and "PEAK_FP32_FLOPS =" not in text
    assert "from repro_torch.launch.roofline import" in text


def test_chip_smoke_takes_the_card_line_from_the_port():
    import pathlib

    text = (pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert "--query-gpu=name,power.limit" not in text
    assert "from repro_torch.runtime.device import card_line" in text


def test_slab_bound_counts_real_columns_only():
    ops, nbytes = RL.slab_counts(20, 128, 1000, 21)
    assert ops == 3.0 * 128 * 1000 * 20
    assert nbytes == 4.0 * 20 * (128 + 1000) + 8.0 * 20 * 128 * 21
    # the knn bench's query block: its tables' bytes bound the small
    # libraries, the operations the large ones (the cut is near Lc 1,450)
    assert RL.bound_ms(*RL.slab_counts(20, 128, 1000, 21))[1] == "bytes"
    assert RL.bound_ms(*RL.slab_counts(20, 128, 64000, 21))[1] == "operations"


TINY = tds.EDMDatasetConfig("Tiny", 150, 40, EDMConfig(E_max=5, lib_block=4))
JAX_KEYS = {"arch", "cell", "mesh", "n_chips", "chunk_rows", "n_chunks",
            "memory", "roofline", "roofline_whole_run"}


def test_dryrun_of_a_tiny_dataset_on_the_cpu_gives_the_report():
    r = edm_dryrun.dryrun(TINY, "cpu", chunks=2, seed=1)
    assert JAX_KEYS <= set(r)
    assert (r["arch"], r["cell"], r["n_chips"]) == ("edm-tiny", "ccm_N40_L150", 1)
    assert (r["chunk_rows"], r["n_chunks"], r["chunks_timed"]) == (4, 10, 2)
    assert r["card"] is None and r["device"] == "cpu"
    # no device number from a CPU run
    assert r["memory"]["peak_bytes_per_device"] is None
    assert r["chunk_share_of_bound"] is None
    assert r["memory"]["futures_bytes"] == 40 * 145 * 4
    assert r["rho_finite"] and r["n_buckets"] == 5
    rl = r["roofline"]
    assert {"t_compute_s", "t_memory_s", "bottleneck", "roofline_fraction"} <= set(rl)
    flops = sum(c["flops"] for c in r["counts"].values())
    assert rl["flops"] == flops and rl["t_compute_s"] == flops / RL.PEAK_FP32_FLOPS
    assert r["roofline_whole_run"]["t_compute_s"] == pytest.approx(
        rl["t_compute_s"] * 10)
    assert r["whole_run_extrapolated_s"]["total"] == pytest.approx(
        r["chunk_s"]["total"] * 10)
    json.dumps(r)


def test_dryrun_cli_writes_its_json(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(edm_dryrun.DATASETS, "tiny", TINY)
    out = tmp_path / "tiny.json"
    rep = edm_dryrun.main(["--dataset", "tiny", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["cell"] == \
        "ccm_N40_L150"
    with pytest.raises(SystemExit):
        edm_dryrun.main(["--dataset", "no_such_dataset", "--device", "cpu"])


def test_dryrun_chunk_counts_follow_the_bucket_plan():
    plan, _ = ccm.make_bucket_plan(np.array([1, 3, 3, 7, 7, 7], np.int32))
    blocks = ccm.target_blocks(tuple(enumerate(plan.counts)), 4)
    c = RL.edm_chunk_counts(8, 6, 100, 8, plan.buckets, blocks)
    Lp = 100 - 7 - 1
    assert c["phase2_knn"] == RL.knn_counts(8, 7, 3, Lp, Lp, 8)
    assert c["phase2_lookup"] == RL.segmented_counts(8, blocks, Lp, Lp, 8)
    assert c["phase2_lookup"][0] == 2.0 * 8 * 6 * Lp * 8


@pytest.mark.parametrize("args,want", [
    # zamba2-7b's shared block, whisper-medium's encoder, its cross and its
    # decoder's self-attention at the serve prompt, llama-3.2-vision-11b's
    # self and cross: bf16, B 4
    ((4, 2048, 2048, 32, 32, 112, 2, True), (0.12165602077249747, "operations")),
    ((4, 1500, 1500, 16, 16, 64, 2, False), (0.03727401415571284, "operations")),
    ((4, 416, 1500, 16, 16, 64, 2, False), (0.010337326592517695, "operations")),
    ((4, 416, 416, 16, 16, 64, 2, True), (0.004069100895522388, "bytes")),
    ((4, 2048, 2048, 32, 8, 128, 2, True), (0.13903545231142567, "operations")),
    ((4, 2048, 1601, 32, 8, 128, 2, False), (0.2172725809180991, "operations")),
])
def test_flash_bounds_at_the_serve_shapes(args, want):
    assert RL.bound_ms(*RL.flash_counts(*args), RL.PEAK_BF16_FLOPS) == want


def test_flash_counts_pairs_by_mask():
    """Operations count the (query, key) pairs the mask keeps: all Sq x Sk
    without it; the top-left triangle with it, and every key for the
    queries past Sk; one head of dh 1 counts 4 a pair."""
    assert RL.flash_counts(1, 3, 5, 1, 1, 1, 4, causal=False)[0] == 4 * 15
    assert RL.flash_counts(1, 3, 5, 1, 1, 1, 4)[0] == 4 * (1 + 2 + 3)
    assert RL.flash_counts(1, 5, 3, 1, 1, 1, 4)[0] == 4 * (1 + 2 + 3 + 3 + 3)
    assert RL.flash_counts(1, 3, 5, 2, 1, 1, 4)[1] == 4 * (2 * 3 * 2 + 2 * 5 * 1)
