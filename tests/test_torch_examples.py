"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU against the JAX package's pipeline on the same series: the
quickstart's verdict, optE and rho (rho within 1e-5: sums in another
order), and the zebrafish example's map (within 1e-5) and edge-recovery
AUC (within 0.01: a rank statistic, so a near-tie in rho may flip one
pair); the LM examples: activations_ccm's ``record_neurons`` on JAX's
parameters within f32 tolerance of JAX's and its CCM map within 1e-5,
the example end to end, and train_lm's loss falling as JAX's step's does
on the same stream."""
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


# --------------------------------------------------------------------------
# the LM examples: activations_ccm and train_lm
# --------------------------------------------------------------------------
def _jax_activations_example():
    """The JAX package's examples/activations_ccm.py as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "activations_ccm.py"
    spec = importlib.util.spec_from_file_location("jax_activations_ccm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_activations_record_neurons_and_ccm_match_jax():
    """record_neurons on the same parameters (params_from_jax) within f32
    tolerance of JAX's; the CCM map of JAX's recorded series within 1e-5."""
    import jax

    from repro.configs import get_config as jget
    from repro.data.pipeline import TokenStream as JStream
    from repro.models import transformer as JT
    from repro_torch.configs import get_config
    from repro_torch.examples import activations_ccm
    from repro_torch.models import transformer as T

    jx = _jax_activations_example()
    jc = jget("smollm-135m", smoke=True)
    params = JT.init_params(jc, jax.random.PRNGKey(0))
    batch = JStream(jc.vocab_size, 2, 96, seed=0).batch_at(99)
    want = np.asarray(jx.record_neurons(params, jc, batch))
    port = T.params_from_jax(jax.tree.map(np.asarray, params),
                             get_config("smollm-135m", smoke=True), "cpu")
    got = activations_ccm.record_neurons(port, get_config("smollm-135m", smoke=True), batch)
    assert got.shape == want.shape == (2 * 8, 96)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    ts = activations_ccm.active_series(want)
    out = activations_ccm.run_causal_inference(ts, activations_ccm.EDMConfig(E_max=6),
                                               device="cpu")
    jout = jrun(ts, JConfig(E_max=6))
    np.testing.assert_array_equal(np.asarray(out.optE), np.asarray(jout.optE))
    np.testing.assert_allclose(np.asarray(out.rho), np.asarray(jout.rho), atol=1e-5, rtol=0)


def test_activations_example_runs_end_to_end(capsys):
    from repro_torch.examples import activations_ccm

    got = activations_ccm.main(["--device", "cpu", "--steps", "3", "--seq", "64"])
    assert len(got["losses"]) == 3 and np.all(np.isfinite(got["losses"]))
    n = got["ts"].shape[0]
    assert got["rho"].shape == (n, n) and np.all(np.isfinite(got["rho"]))
    assert "causal map computed" in capsys.readouterr().out


def test_train_lm_loss_falls_as_jax_does(capsys):
    """The train CLI through train_lm (20 steps, tokens from [0, 64): a
    stream with structure, as in tests/test_system.py) against JAX's step
    on the same stream and train config: both losses fall by more than
    0.05 from step 1 to step 20, the port's final loss within 0.1 of
    JAX's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.data.pipeline import TokenStream as JStream
    from repro.launch import steps as JS
    from repro_torch.examples import train_lm

    _, step, metrics = train_lm.main(["--steps", "20", "--batch", "2", "--seq", "32",
                                      "--device", "cpu", "--token-range", "64"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    first = float(lines[0].split("loss=")[1].split()[0])
    assert step == 20 and lines[0].startswith("step     1 ")
    jc = jget("smollm-135m", smoke=True)
    jtc = JTrainConfig(lr=3e-4, total_steps=20, warmup_steps=1)
    state = JS.TrainState.create(jc, jtc, jax.random.PRNGKey(jtc.seed))
    jstep = jax.jit(JS.make_train_step(jc, jtc))
    stream = JStream(64, 2, 32, seed=jtc.seed)
    losses = []
    for i in range(20):
        state, m = jstep(state, jax.tree.map(jnp.asarray, stream.batch_at(i)))
        losses.append(float(m["loss"]))
    assert first - metrics["loss"] > 0.05 and losses[0] - losses[-1] > 0.05
    assert abs(metrics["loss"] - losses[-1]) < 0.1, (metrics["loss"], losses[-1])
