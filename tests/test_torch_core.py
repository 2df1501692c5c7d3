"""Port core helpers against ``repro.core``: embedding, Pearson rho,
simplex weights (rtol 1e-6), and the config crossing between the two
packages."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import embedding as jemb  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro_torch.core import embedding as temb  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core.types import EDMConfig, config_from_jax  # noqa: E402


@pytest.mark.parametrize("E_max,tau,Tp", [(5, 1, 1), (4, 2, 1), (3, 1, 2)])
def test_lag_matrix_and_future_values_match(E_max, tau, Tp):
    x = np.random.default_rng(E_max).standard_normal((3, 90)).astype(np.float32)
    Lp = 90 - (E_max - 1) * tau - Tp
    V = temb.lag_matrix(torch.tensor(x), E_max, tau, Lp).numpy()
    F = temb.future_values(torch.tensor(x), E_max, tau, Tp, Lp).numpy()
    for s in range(3):
        np.testing.assert_array_equal(
            V[s], np.asarray(jemb.lag_matrix(jnp.asarray(x[s]), E_max, tau, Lp)))
        np.testing.assert_array_equal(
            F[s], np.asarray(jemb.future_values(jnp.asarray(x[s]), E_max, tau, Tp, Lp)))
    np.testing.assert_array_equal(
        temb.delay_embed(torch.tensor(x[0]), 3, tau, Tp).numpy(),
        np.asarray(jemb.delay_embed(jnp.asarray(x[0]), 3, tau, Tp)))


def test_pearson_matches_including_degenerate_series():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 200)).astype(np.float32)
    b = (0.3 * a + rng.standard_normal((6, 200))).astype(np.float32)
    a[2] = 0.5  # constant (dead neuron) series
    b[3] = -1.0
    a[4] = 3e38  # variance overflows to inf -> degenerate
    got = tstats.pearson(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(jstats.pearson(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[2] == 0.0 and got[3] == 0.0 and got[4] == 0.0
    assert np.isfinite(got).all()


def test_simplex_weights_match_ties_and_inf():
    rng = np.random.default_rng(2)
    d = np.sort(rng.uniform(0, 4, (5, 7, 8)).astype(np.float32), axis=-1)
    d[3, 0, :3] = 0.0  # d1 == 0 with three tied neighbours: uniform branch
    d[0, 1, :] = 0.0  # everything tied at 0
    d[1, 2, -2:] = np.inf  # masked entries (k == Lc self-exclusion)
    d[2, 3, :] = np.inf  # all masked
    k_valid = np.arange(2, 7)[:, None, None]  # (5, 1, 1): E + 1 per table
    got = tstats.simplex_weights(torch.tensor(d), torch.tensor(k_valid)).numpy()
    want = np.asarray(jstats.simplex_weights(jnp.asarray(d), jnp.asarray(k_valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[3, 0, :3], 1 / 3, rtol=1e-6)  # k_valid 5
    assert np.isfinite(got).all()
    got_int = tstats.simplex_weights(torch.tensor(d), 4).numpy()
    np.testing.assert_allclose(
        got_int, np.asarray(jstats.simplex_weights(jnp.asarray(d), 4)),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("jax_engine,port_engine", [
    ("reference", "torch-reference"),
    ("pallas-interpret", "cuda"),
    ("pallas-compiled", "cuda"),
])
def test_config_from_jax_keeps_every_field(jax_engine, port_engine):
    jcfg = JaxConfig(E_max=7, tau=2, Tp=3, exclude_self=False, lib_block=5,
                     target_block=99, engine=jax_engine, bucketed=False,
                     stream_depth=3, target_tile=0, knn_impl="unroll",
                     dist_dtype="bfloat16", knn_tile_c=64, k_override=9)
    d = dataclasses.asdict(jcfg)
    cfg = config_from_jax(d)
    got = dataclasses.asdict(cfg)
    assert set(got) == set(d)
    assert got.pop("engine") == port_engine
    d.pop("engine")
    assert got == d
    assert cfg.k_max == jcfg.k_max and cfg.n_points(300) == jcfg.n_points(300)


def test_config_defaults_and_validation_match_jax():
    jd = dataclasses.asdict(JaxConfig())
    pd = dataclasses.asdict(EDMConfig())
    assert pd.pop("engine") == "cuda"
    jd.pop("engine")
    assert pd == jd
    for bad in ({"stream_depth": 0}, {"target_tile": -1}, {"knn_tile_c": -1},
                {"knn_tile_c": -3}, {"k_override": 0}):
        with pytest.raises(ValueError):
            EDMConfig(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)
    with pytest.raises(ValueError):
        config_from_jax({"E_max": 3, "not_a_field": 1})
