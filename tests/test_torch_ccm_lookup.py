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


# segment plans of the segmented lookup: single targets, empty segments,
# and a segment longer than the target block the callers use (5)
SEG_PLANS = [
    ((0, 1), (1, 1), (2, 1)),
    ((2, 4), (0, 0), (1, 13), (0, 1), (2, 3)),
    ((1, 21),),
]


@pytest.mark.parametrize("segs", SEG_PLANS)
def test_segmented_lookup_equals_per_segment_calls(segs):
    """The segmented plain lookup (and the wrapper on the CPU) is the old
    per-segment plain call, concatenated, bit for bit; each segment is
    within tolerance of the JAX op on its table row."""
    B = sum(c for _, c in segs)
    idx, w, Y = _case(45, 6, B, 50, S=12, seed=3)
    idx, w = idx.reshape(4, 3, 45, 6), w.reshape(4, 3, 45, 6)
    ti, tw, tY = torch.tensor(idx), torch.tensor(w), torch.tensor(Y)
    got = ccm_lookup(ti, tw, tY, segs)
    assert got.shape == (4, B, 45)
    assert torch.equal(ccm_lookup_ref(ti, tw, tY, segs), got)
    off = 0
    for row, cnt in segs:
        one = ccm_lookup_ref(ti[:, row], tw[:, row], tY[off : off + cnt])
        assert torch.equal(got[:, off : off + cnt], one)
        for s in range(4) if cnt else ():
            want = np.asarray(jax_lookup(jnp.asarray(idx[s, row]), jnp.asarray(w[s, row]),
                                         jnp.asarray(Y[off : off + cnt]), interpret=True))
            np.testing.assert_allclose(got[s, off : off + cnt].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(Y).max())
        off += cnt


def test_unsegmented_forms_are_one_segment_through_one_table():
    idx, w, Y = _case(33, 4, 9, 40, S=3, seed=4)
    ti, tw, tY = torch.tensor(idx), torch.tensor(w), torch.tensor(Y)
    assert torch.equal(ccm_lookup(ti, tw, tY), ccm_lookup(ti[:, None], tw[:, None], tY,
                                                          ((0, 9),)))
    assert torch.equal(ccm_lookup(ti[1], tw[1], tY),
                       ccm_lookup(ti[1:2, None], tw[1:2, None], tY, ((0, 9),))[0])


def test_segmented_lookup_refuses_segments_that_miss_the_targets():
    idx, w, Y = _case(10, 3, 6, 20, S=2, seed=5)
    ti, tw = torch.tensor(idx)[:, None], torch.tensor(w)[:, None]
    with pytest.raises(ValueError, match="cover 5 targets"):
        ccm_lookup(ti, tw, torch.tensor(Y), ((0, 5),))
