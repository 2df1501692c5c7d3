"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU against the JAX package's pipeline on the same series: the
quickstart's verdict, optE and rho (rho within 1e-5: sums in another
order), and the zebrafish example's map (within 1e-5) and edge-recovery
AUC (within 0.01: a rank statistic, so a near-tie in rho may flip one
pair)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import run_causal_inference as jrun  # noqa: E402
from repro.core.types import EDMConfig as JConfig  # noqa: E402
from repro.data.synthetic import coupled_logistic, logistic_network  # noqa: E402
from repro_torch.examples import quickstart, zebrafish_synthetic  # noqa: E402


def test_quickstart_matches_jax(capsys):
    got = quickstart.main(["--device", "cpu"])
    x, y = coupled_logistic(1000, beta_xy=0.0, beta_yx=0.1, seed=3)
    want = jrun(np.stack([x, y]), JConfig(E_max=8))
    np.testing.assert_array_equal(got["optE"], np.asarray(want.optE))
    np.testing.assert_allclose(got["rho"], np.asarray(want.rho), atol=1e-5, rtol=0)
    jverdict = "x -> y" if want.rho[1, 0] > want.rho[0, 1] else "y -> x"
    assert got["verdict"] == jverdict == "x -> y"
    assert "CCM verdict: x -> y" in capsys.readouterr().out


def test_zebrafish_example_matches_jax(tmp_path, capsys):
    got = zebrafish_synthetic.main([
        "--neurons", "12", "--steps", "200", "--surrogates", "9",
        "--device", "cpu", "--out", str(tmp_path / "zf")])
    ts, adj = logistic_network(12, 200, density=0.12, strength=0.3, seed=7)
    np.testing.assert_array_equal(got["ts"], ts)
    np.testing.assert_array_equal(got["adj"], adj)
    want = jrun(ts, JConfig(E_max=8))
    np.testing.assert_array_equal(got["optE"], np.asarray(want.optE))
    np.testing.assert_allclose(got["rho"], np.asarray(want.rho), atol=1e-5, rtol=0)
    jauc = zebrafish_synthetic.edge_auc(np.asarray(want.rho), adj)
    assert abs(got["auc"] - jauc) <= 0.01
    # the store at <out>/causal_map, its map at <store>/causal_map/data.npy
    assert (tmp_path / "zf" / "causal_map" / "causal_map" / "data.npy").exists()
    assert (tmp_path / "zf" / "edges").is_dir()
    assert "[5/5] significance-masked graph" in capsys.readouterr().out
