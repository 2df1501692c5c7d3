"""The port's flash-attention plain version (``repro_torch.kernels.
flash_attn``) against the JAX package's oracle ``flash_attn_ref`` and its
Pallas wrapper ``flash_attn`` in interpret mode, on the CPU.

Tolerances (docs/PORT.md): float32 within 2e-5 (the JAX kernel test's
bound: f32 sums over the keys in another order); bfloat16 within one
bf16 step, |diff| <= 2^-7 |want| (both sides compute in f32 from the
same bf16 inputs and round once).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ops import flash_attn as jflash  # noqa: E402
from repro.kernels.flash_attn.ref import flash_attn_ref as jref  # noqa: E402
from repro.models.layers import _sdpa_dense as jdense  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: E402

BF16_RTOL = 2.0 ** -7

# the cases of tests/test_kernels.py::test_flash_attn_vs_oracle
KERNEL_CASES = [
    (2, 128, 128, 4, 2, 64, True, 64, 64),
    (1, 256, 256, 6, 6, 32, True, 128, 128),
    (2, 64, 64, 8, 4, 16, False, 32, 32),
    (1, 96, 96, 2, 1, 8, True, 32, 32),
]


def _qkv(B, Sq, Sk, H, K, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, K, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, K, dh)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    out = flash_attn(*(torch.tensor(a).to(dtype) for a in (q, k, v)), causal)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,bq,bk", KERNEL_CASES)
def test_plain_version_matches_jax_oracle_and_pallas_kernel(B, Sq, Sk, H, K, dh,
                                                            causal, bq, bk):
    q, k, v = _qkv(B, Sq, Sk, H, K, dh, Sq + H)
    got = _port(q, k, v, causal)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=bq, block_k=bk))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,bq,bk", KERNEL_CASES)
def test_plain_version_bf16_within_one_bf16_step_of_jax(B, Sq, Sk, H, K, dh,
                                                        causal, bq, bk):
    q, k, v = _qkv(B, Sq, Sk, H, K, dh, 7 + Sq)
    got = _port(q, k, v, causal, torch.bfloat16)
    want = np.asarray(jref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           causal).astype(jnp.float32))
    assert np.all(np.abs(got - want) <= 1e-6 + BF16_RTOL * np.abs(want))


@pytest.mark.parametrize("Sq,Sk", [(40, 40), (40, 57), (1, 33), (70, 70)])
def test_causal_irregular_lengths_match_jax(Sq, Sk):
    """Sq and Sk not multiples of the Pallas block: causal masking keeps
    the JAX wrapper's zero-padded keys out, so it agrees too."""
    q, k, v = _qkv(1, Sq, Sk, 4, 2, 16, Sq * Sk)
    got = _port(q, k, v, True)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, block_q=32, block_k=32))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sk", [40, 33, 100])
def test_noncausal_sk_not_a_block_multiple_matches_the_oracle_only(Sk):
    """Non-causal with Sk not a block multiple: held to ``flash_attn_ref``
    only.  The JAX wrapper pads keys with zeros, which score 0 and enter
    the non-causal softmax (a reference fault, ROADMAP queue 3); the port
    lets only the Sk real keys in.  The test shows the wrapper's error, so
    it fails once the reference is fixed and this exception can go."""
    q, k, v = _qkv(1, 40, Sk, 2, 1, 16, Sk)
    got = _port(q, k, v, False)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=False, block_q=32, block_k=32))
    assert np.abs(pallas - want).max() > 1e-3


def test_plain_version_is_exact_softmax_attention():
    """Against a float64 softmax(q k^T / sqrt(dh)) v, GQA spelled out."""
    B, S, H, K, dh = 2, 19, 6, 2, 8
    q, k, v = _qkv(B, S, S, H, K, dh, 3)
    got = _port(q, k, v, True)
    rep = H // K
    want = np.zeros((B, S, H, dh))
    for b in range(B):
        for h in range(H):
            s = q[b, :, h].astype(np.float64) @ k[b, :, h // rep].T / np.sqrt(dh)
            s[np.triu_indices(S, 1)] = -np.inf
            p = np.exp(s - s.max(1, keepdims=True))
            want[b, :, h] = (p / p.sum(1, keepdims=True)) @ v[b, :, h // rep]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start,Sq,Sk", [(10, 1, 24), (0, 8, 24), (4, 8, 24)])
def test_plain_version_with_q_pos_matches_jax_sdpa_dense(start, Sq, Sk):
    """With ``q_pos`` (decode, prefill into a longer cache) the plain
    version is the model's dense attention: held to the JAX
    ``_sdpa_dense`` with the same q_pos, unwritten slots masked."""
    q, k, v = _qkv(2, Sq, Sk, 4, 2, 16, 30 + start)
    q_pos = np.arange(start, start + Sq)
    got = flash_attn_ref(*(torch.tensor(a) for a in (q, k, v)), True,
                         torch.tensor(q_pos)).numpy()
    want = np.asarray(jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                             jnp.asarray(q_pos)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_wrapper_refuses_tensors_on_mixed_devices():
    q, k, v = (torch.zeros((1, 4, 2, 8)) for _ in range(3))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attn(q, k.to("meta"), v, True)


def test_wrapper_on_the_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 24, 24, 4, 2, 16, 5))
    before = dict(flash_attn.ROUTE_LAUNCHES)
    assert torch.equal(flash_attn(q, k, v, True), flash_attn_ref(q, k, v, True))
    assert flash_attn.ROUTE_LAUNCHES == before  # counts kernel launches only


@pytest.mark.parametrize("device,dtype,dh,route", [
    # bf16 at a head dim that is a multiple of 16 up to 128: the tensor cores
    # (16, 64, 112 and 128 occur in configs/)
    ("cuda", torch.bfloat16, 16, "tensor_core"),
    ("cuda", torch.bfloat16, 64, "tensor_core"),
    ("cuda", torch.bfloat16, 112, "tensor_core"),
    ("cuda", torch.bfloat16, 128, "tensor_core"),
    # every other CUDA call: the CUDA cores
    ("cuda", torch.bfloat16, 8, "cuda_core"),
    ("cuda", torch.bfloat16, 24, "cuda_core"),
    ("cuda", torch.bfloat16, 144, "cuda_core"),
    ("cuda", torch.float32, 128, "cuda_core"),
    ("cuda", torch.float32, 16, "cuda_core"),
    # CPU tensors: the plain version
    ("cpu", torch.bfloat16, 128, "plain"),
    ("cpu", torch.float32, 64, "plain"),
])
def test_route_is_static_on_device_dtype_and_head_dim(device, dtype, dh, route):
    assert flash_route(device, dtype, dh) == route
