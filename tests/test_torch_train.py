"""The port's training loss and gradients against the JAX package's on the
CPU: ``models.transformer.loss_fn`` and every gradient leaf against
``jax.value_and_grad(repro.models.transformer.loss_fn)`` for one smoke
config a family (qwen2.5-3b: QKV bias; minicpm-2b: tied embeddings, both
uses' gradients in ``embed.tok``; dbrx-132b at a capacity that drops;
mamba2-2.7b; zamba2-7b; whisper-medium; llama-3.2-vision-11b), with remat
on and off and on both attention routes, the JAX weights carried across by
``params_from_jax`` with the zero-initialised leaves drawn non-zero
(``tests/torch_lm_fixtures.py::nonzero_tree``), float32.  The reference is
JAX's function on its ``xla`` route without remat: remat and JAX's chunked
route compute that same function.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-5 max(1, max |want|) (the same f32 operations, sums in another order).

Also: ``FlashAttnFn`` (the kernel's autograd Function; on the CPU its
forward is the plain version) against the plain version's autograd at
query chunks smaller than the sequence, a ragged last chunk, GQA, causal
or not, float32 and bfloat16; the MoE counters counting each forward once
under remat; a bare ``flash_attn`` under grad on CUDA tensors raising
(skipped without a card)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels.flash_attn.ops import FlashAttnFn, flash_attn  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_lm_fixtures import batch, cfgs, jax_params, jnp_batch  # noqa: E402

ARCHS = ("qwen2.5-3b", "minicpm-2b", "dbrx-132b", "mamba2-2.7b", "zamba2-7b",
         "whisper-medium", "llama-3.2-vision-11b")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
#: dbrx's smoke capacity at this batch drops assignments (asserted below)
CFG_KW = {"dbrx-132b": dict(capacity_factor=0.5)}
_JAX: dict = {}
_jax_value_and_grad = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True),
                              static_argnums=(2, 3))


def _jax_loss_and_grads(arch):
    """JAX's loss, metrics and gradient tree (numpy), once a module per arch."""
    if arch not in _JAX:
        jc, _ = cfgs(arch, "xla", **CFG_KW.get(arch, {}))
        tree = jax_params(jc)
        tc = JTrainConfig(remat=False)
        (loss, metrics), grads = _jax_value_and_grad(
            jax.tree.map(jnp.asarray, tree), jnp_batch(batch(jc)), jc, tc)
        _JAX[arch] = dict(tree=tree, loss=float(loss),
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads=T.unstack_jax_tree(jax.tree.map(np.asarray, grads)))
    return _JAX[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    want = _jax_loss_and_grads(arch)
    for impl in ("chunked", "xla"):
        _, tc = cfgs(arch, impl, **CFG_KW.get(arch, {}))
        model = T.params_from_jax(want["tree"], tc, device="cpu")
        for remat in (True, False):
            MOE.reset_drop_counts(model)
            loss, metrics = T.loss_fn(model, batch(tc), tc, TrainConfig(remat=remat))
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, [model.get_parameter(n) for n in names])
            assert abs(loss.item() - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), \
                (impl, remat)
            for k in ("ce", "moe_aux"):
                assert abs(metrics[k].item() - want["metrics"][k]) <= LOSS_RTOL * max(
                    1.0, abs(want["metrics"][k])), (k, impl, remat)
            assert set(names) == set(want["grads"])
            for n, g in zip(names, grads):
                w = want["grads"][n]
                tol = GRAD_TOL * max(1.0, float(np.abs(w).max()))
                err = float(np.abs(g.detach().numpy() - w).max())
                assert err <= tol, (n, impl, remat, err, tol)
            if tc.n_experts:
                routed, dropped = MOE.drop_counts(model)
                assert dropped > 0 and routed == tc.n_layers * 2 * 33 * tc.experts_per_tok


def test_tied_embedding_gets_both_uses_gradients():
    """minicpm-2b ties ``embed.tok`` to the head: its gradient is the sum
    of the lookup's and the head's, each matched to JAX above; here the
    head's share alone is non-zero on rows no token looks up."""
    want = _jax_loss_and_grads("minicpm-2b")
    _, tc = cfgs("minicpm-2b", "xla")
    assert tc.tie_embeddings
    model = T.params_from_jax(want["tree"], tc, device="cpu")
    b = batch(tc)
    loss, _ = T.loss_fn(model, b, tc, TrainConfig(remat=False))
    (g,) = torch.autograd.grad(loss, [model.embed.tok])
    unused = sorted(set(range(tc.padded_vocab)) - set(b["tokens"].ravel().tolist()))
    assert float(g[unused].abs().max()) > 0
    np.testing.assert_allclose(g.numpy(), want["grads"]["embed.tok"], rtol=0,
                               atol=GRAD_TOL)


def test_chunked_route_trains_the_projections_before_attention():
    """On the kernel route q, k and v come out of FlashAttnFn with autograd
    history: wq / wk / wv get the plain route's gradients, not none."""
    _, tc = cfgs("qwen2.5-3b", "chunked")
    model = T.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    b = batch(tc)
    got = {}
    for impl in ("chunked", "xla"):
        c = dataclasses.replace(tc, attn_impl=impl)
        loss, _ = T.loss_fn(model, b, c, TrainConfig(remat=False))
        ps = [model.blocks[0].attn.wq.w, model.blocks[0].attn.wk.w,
              model.blocks[0].attn.wv.w, model.embed.tok]
        got[impl] = torch.autograd.grad(loss, ps)
    for a, x in zip(got["chunked"], got["xla"]):
        assert float(x.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), x.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("Sq,Sk,H,K,causal,chunk,dtype", [
    (37, 37, 4, 2, True, 8, "float32"),      # ragged last chunk, GQA
    (37, 37, 4, 4, True, 64, "float32"),     # one chunk
    (20, 29, 6, 3, False, 7, "float32"),     # cross-attention, not causal
    (33, 33, 4, 1, True, 16, "bfloat16"),    # bf16 in, grads in bf16
])
def test_flash_fn_backward_equals_plain_autograd(Sq, Sk, H, K, causal, chunk, dtype):
    """FlashAttnFn's chunked backward against autograd through the plain
    version: float32 within 1e-6; bfloat16 within one bf16 step of the
    plain version's float32 gradients, the outputs in the inputs' dtypes."""
    rng = np.random.default_rng(Sq * Sk)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(rng.standard_normal(s).astype(np.float32)).to(dt)
                   for s in ((2, Sq, H, 16), (2, Sk, K, 16), (2, Sk, K, 16),
                             (2, Sq, H, 16)))

    def grads(fn, *xs):
        xs = [x.detach().requires_grad_() for x in xs]
        o = fn(*xs)
        return (o, *torch.autograd.grad(o, xs, do.to(o.dtype)))

    got = grads(lambda a, b, c: FlashAttnFn.apply(a, b, c, causal, chunk), q, k, v)
    assert all(g.dtype == dt for g in got)
    want = grads(lambda a, b, c: flash_attn_ref(a, b, c, causal),
                 q.float(), k.float(), v.float())
    for g, w in zip(got, want):
        w = w.detach()
        tol = 1e-6 + 1e-6 * w.abs() if dtype == "float32" else 2.0 ** -8 * w.abs() + 1e-6
        assert bool(((g.detach().float() - w).abs() <= tol).all())


def test_moe_counts_each_forward_once_under_remat():
    """The recompute pass of a checkpointed MoE layer does not count again:
    a forward and backward under remat count what the forward alone does."""
    _, tc = cfgs("dbrx-132b", "xla", capacity_factor=0.5)
    model = T.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    b = batch(tc)
    with torch.no_grad():
        T.loss_fn(model, b, tc, TrainConfig(remat=True))
    once = MOE.drop_counts(model)
    assert once[1] > 0
    MOE.reset_drop_counts(model)
    loss, _ = T.loss_fn(model, b, tc, TrainConfig(remat=True))
    assert MOE.drop_counts(model) == once
    loss.backward()  # recomputes every layer's forward
    assert MOE.drop_counts(model) == once


def test_bare_flash_attn_under_grad_on_the_cpu_is_the_plain_version():
    """On CPU tensors flash_attn is the plain version and trains through it."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    o = flash_attn(q, k, v, True)
    assert o.requires_grad
    (g,) = torch.autograd.grad(o.sum(), q)
    assert float(g.abs().max()) > 0


def test_bare_flash_attn_under_grad_on_cuda_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    q = torch.randn(1, 64, 2, 16, device=dev, requires_grad=True)
    k, v = torch.randn(1, 64, 2, 16, device=dev), torch.randn(1, 64, 2, 16, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attn(q, k, v, True)
    with torch.no_grad():
        assert not flash_attn(q, k, v, True).requires_grad
