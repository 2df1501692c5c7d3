"""The port's plain ccm_lookup (the kernel's plain version) against the
JAX op in interpret mode, ragged shapes included.  Tolerance: |diff| <=
1e-6 * max|Y| — the two sum the k products in different orders."""
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ccm_lookup.ops import ccm_lookup as jax_lookup  # noqa: E402
from repro_torch.kernels.ccm_lookup.ops import ccm_lookup  # noqa: E402
from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref  # noqa: E402


def _case(Lq, k, B, Lp, S=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if S is None else (S,)
    idx = rng.integers(0, Lp, lead + (Lq, k)).astype(np.int32)
    w = rng.uniform(0, 1, lead + (Lq, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    Y = (3.0 * rng.standard_normal((B, Lp))).astype(np.float32)
    return idx, w, Y


@pytest.mark.parametrize("Lq,k,B,Lp", [(70, 6, 37, 90), (64, 4, 8, 64),
                                        (129, 21, 33, 140), (1, 1, 1, 5)])
def test_plain_lookup_matches_jax_op(Lq, k, B, Lp):
    idx, w, Y = _case(Lq, k, B, Lp)
    got = ccm_lookup(torch.tensor(idx), torch.tensor(w), torch.tensor(Y)).numpy()
    want = np.asarray(jax_lookup(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(Y),
                                 block_b=8, block_t=32, interpret=True))
    assert got.shape == (B, Lq)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(Y).max())


def test_batched_tables_equal_one_call_per_table():
    idx, w, Y = _case(50, 5, 19, 60, S=4, seed=1)
    got = ccm_lookup(torch.tensor(idx), torch.tensor(w), torch.tensor(Y))
    assert got.shape == (4, 19, 50)
    for s in range(4):
        one = ccm_lookup_ref(torch.tensor(idx[s]), torch.tensor(w[s]), torch.tensor(Y))
        assert torch.equal(got[s], one)
        want = np.asarray(jax_lookup(jnp.asarray(idx[s]), jnp.asarray(w[s]),
                                     jnp.asarray(Y), interpret=True))
        np.testing.assert_allclose(got[s].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(Y).max())


def test_lookup_sums_neighbours_in_ascending_order():
    """The plain version's float sequence is the kernel's: acc = 0, then
    acc + w_j * y_j for j = 0..k-1, each rounded on its own."""
    idx, w, Y = _case(30, 7, 5, 40, seed=2)
    got = ccm_lookup_ref(torch.tensor(idx), torch.tensor(w), torch.tensor(Y)).numpy()
    acc = np.zeros((5, 30), np.float32)
    for j in range(7):
        acc = (acc + (w[None, :, j] * Y[:, idx[:, j]]).astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got, acc)
