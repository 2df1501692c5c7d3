"""``repro_torch.core.extensions`` held to ``repro.core.extensions`` on the
CPU: the S-Map theta sweep and the time-delayed CCM on the JAX tests'
fixtures (the coupled logistic pair, an AR(1) linear series with a flat
theta curve), within 1e-5 of JAX (float32 sums and a 3x3 solve in
another order: measured up to 9e-7); the JAX tests' own claims hold on
the port's values; a batch equals its series one by one; the ``cuda``
engine's wrappers (their plain versions on the CPU) equal
``torch-reference``; without a card the default device raises."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import extensions as jext  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro_torch.core import extensions as ext  # noqa: E402
from repro_torch.core.types import EDMConfig  # noqa: E402

TOL = 1e-5
LAGS = (-4, -3, -2, -1, 0, 1, 2, 3, 4)


@pytest.fixture(scope="module")
def ar1():
    rng = np.random.default_rng(0)
    x = np.zeros(600, np.float32)
    for t in range(1, 600):
        x[t] = 0.8 * x[t - 1] + 0.1 * rng.standard_normal()
    return x


@pytest.mark.parametrize("E", [2, 3])
def test_smap_theta_sweep_matches_jax(coupled_pair, E):
    x = coupled_pair[0].astype(np.float32)
    got = ext.smap_theta_sweep(x, E, EDMConfig(E_max=6), device="cpu").numpy()
    want = np.asarray(jext.smap_theta_sweep(jnp.asarray(x), E, JaxConfig(E_max=6)))
    assert got.shape == want.shape == (len(ext.THETAS),)
    assert np.abs(got - want).max() <= TOL
    # JAX's claim: logistic dynamics are state dependent
    assert got.max() > got[0] + 0.02 and np.argmax(got) > 0


def test_smap_linear_system_flat_theta_matches_jax(ar1):
    got = ext.smap_theta_sweep(ar1, 2, EDMConfig(E_max=6), device="cpu").numpy()
    want = np.asarray(jext.smap_theta_sweep(jnp.asarray(ar1), 2, JaxConfig(E_max=6)))
    assert np.abs(got - want).max() <= TOL
    assert got.max() <= got[0] + 0.05


@pytest.mark.parametrize("E", [2, 3])
def test_ccm_lagged_matches_jax(coupled_pair, E):
    x, y = (coupled_pair[i].astype(np.float32) for i in (0, 1))
    got = ext.ccm_lagged(y, x, E, EDMConfig(E_max=6), LAGS, device="cpu").numpy()
    want = np.asarray(jext.ccm_lagged(jnp.asarray(y), jnp.asarray(x), E,
                                      JaxConfig(E_max=6), LAGS))
    assert got.shape == want.shape == (len(LAGS),)
    assert np.abs(got - want).max() <= TOL
    assert LAGS[int(np.argmax(got))] <= 0  # x drives y: the cause precedes


def test_a_batch_equals_its_series_one_by_one(coupled_pair, ar1):
    cfg = EDMConfig(E_max=6)
    xs = np.stack([coupled_pair[0][:600], coupled_pair[1][:600], ar1])
    sweep = ext.smap_theta_sweep(xs, 2, cfg, device="cpu")
    lagged = ext.ccm_lagged(xs, xs[::-1].copy(), 3, cfg, device="cpu")
    assert sweep.shape == (3, len(ext.THETAS)) and lagged.shape == (3, len(LAGS))
    for s in range(3):
        torch.testing.assert_close(
            sweep[s], ext.smap_theta_sweep(xs[s], 2, cfg, device="cpu"),
            rtol=0, atol=1e-6)
        assert torch.equal(lagged[s], ext.ccm_lagged(xs[s], xs[2 - s], 3, cfg,
                                                     device="cpu"))


def test_ccm_lagged_cuda_engine_equals_torch_reference(coupled_pair):
    x, y = coupled_pair
    a = ext.ccm_lagged(y, x, 3, EDMConfig(E_max=6, engine="cuda"), device="cpu")
    b = ext.ccm_lagged(y, x, 3, EDMConfig(E_max=6, engine="torch-reference"),
                       device="cpu")
    assert torch.equal(a, b)


def test_extensions_run_on_the_card_by_default(coupled_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: ext.smap_theta_sweep(coupled_pair[0], 2, EDMConfig()),
                 lambda: ext.ccm_lagged(*coupled_pair, 2, EDMConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
