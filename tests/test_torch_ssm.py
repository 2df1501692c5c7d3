"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py`` on the CPU, float32, on the same numpy
weights and inputs: outputs and states within 1e-5 + 1e-5 |want| (the
same f32 operations, contracted in another order); the chunked forward
against the step-by-step decode within 2e-4, the JAX tests' bound
(tests/test_models.py).

The prompts are short on purpose: one step, two (below d_conv - 1 = 3),
three, below a chunk (8), a chunk, and not a multiple of it.  Below
d_conv - 1 steps JAX's conv tail wraps around and is shorter than its
decode takes; the port's is zero rows then the raw rows, which the
short-prompt test holds against the full sequence's forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
DIMS = dict(d_model=16, d_state=4, head_dim=4, chunk=8)  # H 8, conv_dim 40
PROMPTS = (1, 2, 3, 5, 8, 13, 20)


def _tree(seed):
    """JAX's init layout, with weights at a scale where the state grows."""
    rng = np.random.default_rng(seed)
    s = JS.SSMDims(**DIMS)
    d_in = 2 * s.d_inner + 2 * s.d_state + s.n_heads
    t = {"in_proj": {"w": 0.3 * rng.standard_normal((s.d_model, d_in))},
         "conv_w": 0.5 * rng.standard_normal((s.d_conv, s.conv_dim)),
         "conv_b": 0.1 * rng.standard_normal(s.conv_dim),
         "A_log": np.log(np.linspace(1.0, 16.0, s.n_heads)),
         "D": 1.0 + 0.1 * rng.standard_normal(s.n_heads),
         "dt_bias": 0.1 * rng.standard_normal(s.n_heads),
         "norm_scale": 1.0 + 0.1 * rng.standard_normal(s.d_inner),
         "out_proj": {"w": 0.3 * rng.standard_normal((s.d_inner, s.d_model))}}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), t)


def _port(tree):
    m = S.Mamba(S.SSMDims(**DIMS), torch.float32, "cpu")
    with torch.no_grad():
        for name, val in tree.items():
            if isinstance(val, dict):
                getattr(m, name).w.copy_(torch.from_numpy(val["w"]))
            else:
                getattr(m, name).copy_(torch.from_numpy(val))
    return m


def _u(B, S0, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((B, S0, 16))).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


JD, TD = JS.SSMDims(**DIMS), S.SSMDims(**DIMS)


@pytest.mark.parametrize("S0", PROMPTS)
def test_mamba_fwd_and_state_match_jax(S0):
    tree = _tree(0)
    u = _u(2, S0, 1)
    yj, stj = JS.mamba_fwd(tree, JD, jnp.asarray(u), return_state=True)
    m = _port(tree)
    y, st = S.mamba_fwd(m, TD, torch.from_numpy(u), return_state=True)
    _close(y, yj)
    assert st["ssm"].dtype == torch.float32
    _close(st["ssm"], stj["ssm"])
    assert tuple(st["conv"].shape) == (2, 3, 40)
    n = stj["conv"].shape[1]  # JAX's tail: 3 rows from 3 steps on
    _close(st["conv"][:, 3 - n:], stj["conv"])
    _close(S.mamba_fwd(m, TD, torch.from_numpy(u)), yj)


@pytest.mark.parametrize("S0", [s for s in PROMPTS if s >= 3])
def test_mamba_decode_step_matches_jax(S0):
    """From JAX's prefill state, one decode step: output and new state."""
    tree = _tree(2)
    u = _u(2, S0 + 1, 3)
    _, stj = JS.mamba_fwd(tree, JD, jnp.asarray(u[:, :S0]), return_state=True)
    yj, newj = JS.mamba_decode_step(tree, JD, jnp.asarray(u[:, S0:]), stj)
    st = {k: torch.from_numpy(np.array(v)) for k, v in stj.items()}
    y, new = S.mamba_decode_step(_port(tree), TD, torch.from_numpy(u[:, S0:]), st)
    _close(y, yj)
    for k in ("conv", "ssm"):
        _close(new[k], newj[k])
    np.testing.assert_array_equal(st["ssm"].detach().numpy(), np.asarray(stj["ssm"]))  # unwritten


@pytest.mark.parametrize("S0", [1, 2])
def test_short_prompt_state_is_zero_padded_and_continues(S0):
    """Below d_conv - 1 steps: the tail is zero rows then the raw conv
    inputs, and prefill + one decode step equals the forward of S0 + 1
    steps, the port's and JAX's."""
    tree = _tree(4)
    u = _u(2, S0 + 1, 5)
    m = _port(tree)
    _, st = S.mamba_fwd(m, TD, torch.from_numpy(u[:, :S0]), return_state=True)
    assert not st["conv"][:, : 3 - S0].any()
    raw = torch.from_numpy(u[:, :S0]) @ m.in_proj.w
    xBC = raw[..., TD.d_inner : 2 * TD.d_inner + 2 * TD.d_state]
    _close(st["conv"][:, 3 - S0:], xBC.detach().numpy())
    y_last, _ = S.mamba_decode_step(m, TD, torch.from_numpy(u[:, S0:]), st)
    full = S.mamba_fwd(m, TD, torch.from_numpy(u))
    _close(y_last[:, 0], full[:, S0].detach().numpy(), **STEP_TOL)
    _close(y_last[:, 0], np.asarray(JS.mamba_fwd(tree, JD, jnp.asarray(u)))[:, S0],
           **STEP_TOL)


def test_mamba_fwd_equals_stepwise_decode():
    """As tests/test_models.py::test_mamba_fwd_equals_stepwise_decode:
    the chunked forward equals the recurrence, token by token."""
    tree = _tree(6)
    m = _port(tree)
    u = torch.from_numpy(_u(2, 24, 7))
    y_chunked = S.mamba_fwd(m, TD, u)
    state = S.mamba_init_state(TD, 2, torch.float32)
    ys = []
    for t in range(24):
        y_t, state = S.mamba_decode_step(m, TD, u[:, t : t + 1], state)
        ys.append(y_t)
    _close(y_chunked, torch.cat(ys, 1).detach().numpy(), **STEP_TOL)


def test_mamba_prefill_state_continues_correctly():
    """As tests/test_models.py::test_mamba_prefill_state_continues_correctly:
    the state handed off by the forward continues the recurrence."""
    tree = _tree(8)
    m = _port(tree)
    u = torch.from_numpy(_u(1, 20, 9))
    _, st = S.mamba_fwd(m, TD, u[:, :19], return_state=True)
    y_last, _ = S.mamba_decode_step(m, TD, u[:, 19:20], st)
    y_full = S.mamba_fwd(m, TD, u)
    _close(y_last[:, 0], y_full[:, 19].detach().numpy(), **STEP_TOL)


def test_mamba_block_keeps_float32_leaves():
    m = S.Mamba(TD, torch.bfloat16, "cpu")
    assert {n for n, p in m.named_parameters() if p.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    st = S.mamba_init_state(TD, 3, torch.bfloat16)
    assert st["conv"].dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    assert tuple(st["ssm"].shape) == (3, 8, 4, 4) and tuple(st["conv"].shape) == (3, 3, 40)
