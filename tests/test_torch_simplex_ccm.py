"""Phase 1 and phase 2 of the port against the JAX package on the CPU.

Phase 1: simplex rhos within 1e-5 and optE equal; a near-tie (top two
rhos within 1e-5) is named in the failure message.  Phase 2: the port's
bucketed ccm_matrix, fed the JAX optE, against the JAX untiled
ccm_matrix (engine ``reference``) within 1e-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ccm as jccm  # noqa: E402
from repro.core import simplex as jsimplex  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.data.synthetic import dummy_brain  # noqa: E402
from repro_torch.core import ccm as tccm  # noqa: E402
from repro_torch.core import simplex as tsimplex  # noqa: E402
from repro_torch.core.types import config_from_jax  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402

TOL = 1e-5


def _datasets(coupled_pair, small_network):
    return {
        "coupled_pair": coupled_pair,
        "small_network": small_network[0],
        "dummy_brain": dummy_brain(16, 300, seed=5),
    }


def _near_ties(rhos: np.ndarray) -> list[int]:
    top2 = np.sort(rhos, axis=-1)[:, -2:]
    return [int(i) for i in np.nonzero(top2[:, 1] - top2[:, 0] < TOL)[0]]


@pytest.mark.parametrize("name", ["coupled_pair", "small_network", "dummy_brain"])
@pytest.mark.parametrize("engine", ["cuda", "torch-reference"])
def test_phase1_matches_jax(name, engine, coupled_pair, small_network):
    ts = _datasets(coupled_pair, small_network)[name]
    jcfg = JaxConfig(E_max=5)
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)), engine=engine)
    j_rhos, j_optE = jsimplex.simplex_batch(jnp.asarray(ts), jcfg)
    t_rhos, t_optE = tsimplex.simplex_batch(torch.tensor(ts), cfg)
    j_rhos, j_optE = np.asarray(j_rhos), np.asarray(j_optE)
    err = np.abs(t_rhos.numpy() - j_rhos).max()
    assert err <= TOL, f"{name}: simplex rho differs by {err}"
    ties = _near_ties(j_rhos)
    assert t_optE.dtype == torch.int32
    assert np.array_equal(t_optE.numpy(), j_optE), (
        f"{name}: optE differs at {np.nonzero(t_optE.numpy() != j_optE)[0]}; "
        f"near-ties (top two rhos within {TOL}) at series {ties}")


@pytest.mark.parametrize("name", ["coupled_pair", "small_network", "dummy_brain"])
def test_phase2_ccm_matrix_matches_untiled_jax(name, coupled_pair, small_network):
    ts = _datasets(coupled_pair, small_network)[name]
    jcfg = JaxConfig(E_max=5, lib_block=3, target_block=5)
    _, j_optE = jsimplex.simplex_batch(jnp.asarray(ts), jcfg)
    j_optE = np.asarray(j_optE)
    want = np.asarray(jccm.ccm_matrix(jnp.asarray(ts), jnp.asarray(j_optE), jcfg))
    for engine in ("cuda", "torch-reference"):
        cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                                  engine=engine)
        got = tccm.ccm_matrix(torch.tensor(ts), j_optE, cfg).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= TOL, f"{name} ({engine}): rho differs by {err}"


def test_bucket_plan_matches_jax():
    optE = np.array([3, 1, 3, 2, 5, 1, 3], np.int32)
    tp, to = tccm.make_bucket_plan(optE)
    jp, jo = jccm.make_bucket_plan(optE)
    assert (tp.buckets, tp.counts, tp.offsets) == (jp.buckets, jp.counts, jp.offsets)
    np.testing.assert_array_equal(to, jo)


def test_synthetic_copy_matches_jax_package():
    from repro.data import synthetic as jsynthetic

    np.testing.assert_array_equal(tsynthetic.dummy_brain(5, 80, seed=2),
                                  jsynthetic.dummy_brain(5, 80, seed=2))
    for a, b in zip(tsynthetic.coupled_logistic(90, seed=1),
                    jsynthetic.coupled_logistic(90, seed=1)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsynthetic.logistic_network(4, 60, seed=1),
                    jsynthetic.logistic_network(4, 60, seed=1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("target_block", [1, 3, 7, None])
def test_row_lookup_bucketed_same_at_every_target_block(target_block):
    """Target blocks cross segment boundaries (segments of 1 to 9
    targets); every block width gives the width-N values bit for bit on
    the CPU, within tolerance of JAX's ccm_row_lookup_bucketed."""
    ts = dummy_brain(23, 300, seed=7)
    jcfg = JaxConfig(E_max=5, lib_block=4, target_block=5)
    optE = np.array([1, 3, 3, 2, 5, 5, 5, 5, 5, 5, 5, 5, 5, 2, 4, 4, 1, 3, 2, 2,
                     4, 4, 4], np.int32)
    plan, order = jccm.make_bucket_plan(optE)
    seg_plan = tuple(enumerate(plan.counts))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    rows = torch.tensor(ts[:4])
    fut = tccm.all_futures(torch.tensor(ts), cfg)[torch.as_tensor(order)]
    idx, w = tccm.ccm_row_tables_bucketed(rows, cfg, tccm.make_bucket_plan(optE)[0])
    n = fut.shape[0]
    full = tccm.ccm_row_lookup_bucketed(
        idx, w, fut, dataclasses.replace(cfg, target_block=n), seg_plan)
    got = tccm.ccm_row_lookup_bucketed(
        idx, w, fut, dataclasses.replace(cfg, target_block=target_block or n), seg_plan)
    assert got.shape == (4, n)
    assert torch.equal(got, full)
    jidx, jw = (jnp.asarray(a.numpy()) for a in (idx, w))
    want = np.stack([
        np.asarray(jccm.ccm_row_lookup_bucketed(jidx[s], jw[s], jnp.asarray(fut.numpy()),
                                                jcfg, seg_plan))
        for s in range(4)
    ])
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("target_block", [1, 3, 7, 16])
def test_phase2_map_matches_jax_at_every_target_block(target_block):
    """The port's bucketed map at any target block stays within TOL of
    the JAX untiled ccm_matrix; optE (phase 1) equal."""
    ts = dummy_brain(16, 300, seed=5)
    jcfg = JaxConfig(E_max=5, lib_block=3, target_block=5)
    _, j_optE = jsimplex.simplex_batch(jnp.asarray(ts), jcfg)
    j_optE = np.asarray(j_optE)
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                              target_block=target_block)
    _, t_optE = tsimplex.simplex_batch(torch.tensor(ts), cfg)
    assert np.array_equal(t_optE.numpy(), j_optE)
    want = np.asarray(jccm.ccm_matrix(jnp.asarray(ts), jnp.asarray(j_optE), jcfg))
    got = tccm.ccm_matrix(torch.tensor(ts), j_optE, cfg).numpy()
    assert np.abs(got - want).max() <= TOL


def test_target_blocks_cut_across_segments():
    blocks = tccm.target_blocks(((0, 2), (1, 5), (2, 1)), 3)
    assert blocks == ((0, 3, ((0, 2), (1, 1))), (3, 6, ((1, 3),)),
                      (6, 8, ((1, 1), (2, 1))))
    assert tccm.target_blocks(((0, 2), (1, 5), (2, 1)), 8) == (
        (0, 8, ((0, 2), (1, 5), (2, 1))),)
    with pytest.raises(ValueError, match="target_block"):
        tccm.target_blocks(((0, 2),), 0)
