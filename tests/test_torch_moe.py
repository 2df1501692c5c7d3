"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``moe_fwd`` on the CPU, float32, on the same numpy weights and
inputs: y within 1e-5 + 1e-5 |want| (the same f32 products, summed in
another order: an index dispatch against JAX's one-hot einsums), the
aux loss within 1e-6.

The cases drop (capacity below the demand, where the slot-major order
decides who keeps a place), pad (tokens not a multiple of the group),
split into several groups, and tie (a router whose columns repeat, so
the top-k must break ties toward the lower expert index as
``jax.lax.top_k`` does).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

D, F_, E, K = 16, 32, 4, 2
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6

# name: (B, S, capacity_factor, group_size, no_drop, tied router)
CASES = {
    "no_drops": (2, 8, 2.0, 16, False, False),
    "drops": (2, 16, 0.5, 32, False, False),
    "padding": (3, 7, 1.25, 8, False, False),
    "groups": (4, 16, 0.75, 16, False, False),
    "no_drop_flag": (2, 16, 0.5, 32, True, False),
    "ties": (2, 16, 0.5, 32, False, True),
}


def _tree(act, seed, tied=False):
    """Weights at a scale where every expert's output is O(1)."""
    rng = np.random.default_rng(seed)
    t = {"router": rng.standard_normal((D, E)),
         "w_up": 0.3 * rng.standard_normal((E, D, F_)),
         "w_down": 0.3 * rng.standard_normal((E, F_, D))}
    if act == "swiglu":
        t["w_gate"] = 0.3 * rng.standard_normal((E, D, F_))
    if tied:  # experts 1, 2 and 3 score alike: the second slot is a 3-way tie
        t["router"][:, 2] = t["router"][:, 1]
        t["router"][:, 3] = t["router"][:, 1]
    return {k: v.astype(np.float32) for k, v in t.items()}


def _port(tree, act):
    m = M.MoE(D, F_, E, act, torch.float32, "cpu")
    with torch.no_grad():
        for name, arr in tree.items():
            getattr(m, name).copy_(torch.from_numpy(arr))
    return m


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _slot_major_drops(experts, valid, C):
    """Dropped (token, slot) assignments by a loop: every token's first
    choice, then every token's second, each taking its expert's next place."""
    dropped = 0
    for ids, ok in zip(experts, valid):  # groups
        used = np.zeros(E, int)
        for slot in range(ids.shape[1]):
            for t in range(ids.shape[0]):
                if ok[t]:
                    e = ids[t, slot]
                    dropped += used[e] >= C
                    used[e] += 1
    return dropped


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_fwd_matches_jax(act, case):
    B, S, cf, gs, no_drop, tied = CASES[case]
    tree = _tree(act, 1, tied)
    x = _x(B, S, 2)
    yj, aj = JM.moe_fwd({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
                        E, K, act, cf, gs, no_drop)
    m = _port(tree, act)
    y, aux = M.moe_fwd(m, torch.from_numpy(x), E, K, act, cf, gs, no_drop)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **TOL)
    assert abs(float(aux) - float(aj)) <= AUX_TOL

    # the drop counter against a slot-major loop over the port's own routing
    T0, g = B * S, min(gs, B * S)
    T = -(-T0 // g) * g
    xt = np.pad(x.reshape(T0, D), ((0, T - T0), (0, 0))).reshape(-1, g, D)
    probs = torch.softmax(torch.from_numpy(xt) @ m.router, -1)
    _, ids = M._top_k(probs, K)
    valid = (np.arange(T) < T0).reshape(-1, g)
    C = g if no_drop else max(1, int(cf * g * K / E))
    assert torch.equal(m.last_experts, ids)
    routed, dropped = M.drop_counts(m)
    assert routed == T0 * K
    assert dropped == _slot_major_drops(ids.detach().numpy(), valid, C)
    assert (dropped > 0) == (case not in ("no_drops", "no_drop_flag"))
    if case == "padding":
        assert T > T0
    if case == "ties":  # the tie did decide: expert 3 never beats 1 or 2
        assert not (ids == 3).any() and bool((probs[..., 1] == probs[..., 3]).all())


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = M._top_k(p, 2)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(p.detach().numpy()), 2)
    assert idx.tolist() == np.asarray(want_idx).tolist() == [[1, 2], [0, 1]]
    np.testing.assert_array_equal(vals.detach().numpy(), np.asarray(want_vals))


def test_moe_no_drop_is_exact_topk_mixture():
    """As tests/test_models.py::test_moe_no_drop_is_exact_topk_mixture, on
    the port: with no_drop the output is the per-token top-k sum."""
    tree = _tree("swiglu", 3)
    m = _port(tree, "swiglu")
    x = torch.from_numpy(_x(2, 8, 4))
    y, _ = M.moe_fwd(m, x, E, K, "swiglu", group_size=16, no_drop=True)
    probs = torch.softmax(x @ m.router, -1)
    gv, ei = torch.topk(probs, K)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for b in range(2):
        for s in range(8):
            for j in range(K):
                e, xt = int(ei[b, s, j]), x[b, s]
                h = torch.nn.functional.silu(xt @ m.w_gate[e]) * (xt @ m.w_up[e])
                want[b, s] += gv[b, s, j] * (h @ m.w_down[e])
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert M.drop_counts(m) == (2 * 8 * K, 0)


def test_moe_bf16_matches_jax_within_a_bf16_step():
    """bfloat16 experts, float32 router: y within two bf16 steps of JAX's
    (2^-7 (|want| + max |want|)): both round the expert products to bf16;
    JAX's combine is a bf16 contraction, the port's sums in f32 and rounds
    once."""
    tree = _tree("swiglu", 5)
    x = _x(2, 16, 6)
    jt = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in tree.items()}
    yj, aj = JM.moe_fwd(jt, jnp.asarray(x, jnp.bfloat16), E, K, "swiglu", 0.5, 32)
    m = M.MoE(D, F_, E, "swiglu", torch.bfloat16, "cpu")
    with torch.no_grad():
        for name, arr in jt.items():
            getattr(m, name).copy_(torch.from_numpy(np.array(arr, np.float32)))
    assert m.router.dtype == torch.float32 and m.w_up.dtype == torch.bfloat16
    y, aux = M.moe_fwd(m, torch.from_numpy(x).bfloat16(), E, K, "swiglu", 0.5, 32)
    assert y.dtype == torch.bfloat16
    want = np.asarray(yj, np.float32)
    step = 2.0 ** -7 * (np.abs(want) + np.abs(want).max())
    assert (np.abs(y.float().detach().numpy() - want) <= step).all()
    assert abs(float(aux) - float(aj)) <= AUX_TOL


def test_reset_drop_counts():
    m = _port(_tree("gelu", 7), "gelu")
    M.moe_fwd(m, torch.from_numpy(_x(2, 16, 8)), E, K, "gelu", 0.5, 32)
    assert M.drop_counts(m)[1] > 0
    M.reset_drop_counts(m)
    assert M.drop_counts(m) == (0, 0)
