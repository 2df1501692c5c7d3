"""The port's train step, optimizers and schedules against the JAX
package's on the CPU.

- Two train steps of ``launch.steps.make_train_step`` against JAX's jitted
  ``make_train_step`` from the same state (carried across by
  ``train_state_from_jax``; the smoke configs' zero-initialised leaves
  drawn non-zero): AdamW and Adafactor, micro-batches 0 and 2, the cosine,
  WSD and constant schedules, on minicpm-2b (tied embeddings) and, with
  Adafactor, dbrx-132b (stacked expert weights: its leaf groups).  The
  metrics within 1e-5 relative; every parameter and optimizer leaf within
  1e-5 max(1, max |want|) (parameters) or 1e-5 max |want| (moments,
  accumulators).  AdamW's first steps are nearly lr sign(g): an entry
  whose gradient is near zero may take the other sign by rounding and
  move 2 lr; such entries are counted and reported, and each must have
  |g| below 1e-6 max |g| of its leaf at the step it moved.
- The optimizers alone on random trees, 5 steps, against JAX's
  (Adafactor also on a stacked group), and the schedules at every step.
- ``grad_compress``'s local functions bit for bit.
- The JAX system test's training claim on the port: the smollm-135m smoke
  loss falls by 1.0 in 30 steps.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import adafactor as jada  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim.schedule import make_schedule as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adafactor, adamw, grad_compress  # noqa: E402
from repro_torch.optim.schedule import make_schedule  # noqa: E402
from torch_lm_fixtures import cfgs, nonzero_tree  # noqa: E402

REL = 1e-5
#: (arch, optimizer, microbatch, schedule)
STEP_CASES = [
    ("minicpm-2b", "adamw", 0, "cosine"),
    ("minicpm-2b", "adamw", 2, "wsd"),
    ("minicpm-2b", "adafactor", 0, "constant"),
    ("minicpm-2b", "adafactor", 2, "cosine"),
    ("dbrx-132b", "adafactor", 0, "wsd"),
]
B, SEQ = 4, 17
_JAX: dict = {}


def _tcs(opt, micro, sched):
    kw = dict(optimizer=opt, microbatch=micro, schedule=sched, lr=1e-3, warmup_steps=1,
              total_steps=3, remat=True)
    return JTrainConfig(**kw), TrainConfig(**kw)


def _batch(cfg):
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_two_steps(case):
    """The JAX state before and after each of two jitted steps, and the
    metrics, once a module per case."""
    if case not in _JAX:
        arch, opt, micro, sched = case
        jc, _ = cfgs(arch, "xla")
        jt, _ = _tcs(opt, micro, sched)
        st = _np(JS.TrainState.create(jc, jt, jax.random.PRNGKey(0)))
        st = dataclasses.replace(st, params=nonzero_tree(st.params))
        step = jax.jit(JS.make_train_step(jc, jt))
        b = {k: jnp.asarray(v) for k, v in _batch(jc).items()}
        states, metrics = [st], []
        cur = jax.tree.map(jnp.asarray, st)
        for _ in range(2):
            cur, m = step(cur, b)
            states.append(_np(cur))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX[case] = (states, metrics)
    return _JAX[case]


def _port_grads(state, tc, cfg, batch):
    """The gradient the port's step consumes (before clipping)."""
    loss_of = lambda p, b: T.loss_fn(p, b, cfg, tc)
    if tc.microbatch > 0:
        return S._accumulated_grads(loss_of, state.params, batch, tc.microbatch)[0]
    return S._grads(loss_of(state.params, batch)[0], state.params)


def _close(got, want, tol, what):
    err = np.abs(got - want)
    assert float(err.max(initial=0.0)) <= tol, (what, float(err.max()), tol)


@pytest.mark.parametrize("case", STEP_CASES, ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_two_train_steps_match_jax(case):
    arch, opt, micro, sched = case
    states, jmetrics = _jax_two_steps(case)
    _, pc = cfgs(arch, "xla")
    _, pt = _tcs(opt, micro, sched)
    state = S.train_state_from_jax(states[0], pc, pt, device="cpu")
    step = S.make_train_step(pc, pt, device="cpu")
    b = _batch(pc)
    flipped = []
    grads_seen = []
    for i in range(2):
        grads_seen.append({k: g.detach().numpy() for k, g in
                           _port_grads(state, pt, pc, b).items()})
        state, m = step(state, b)
        for k, want in jmetrics[i].items():
            assert abs(m[k].item() - want) <= REL * max(1.0, abs(want)), (k, i)
        want = states[i + 1]
        assert int(state.step) == int(want.step) == i + 1
        assert int(state.opt["count"]) == int(want.opt["count"])
        wp = T.unstack_jax_tree(want.params)
        for name, p in state.params.named_parameters():
            w = wp[name]
            diff = np.abs(p.detach().numpy() - w)
            bad = diff > REL * max(1.0, float(np.abs(w).max()))
            if bad.any():  # AdamW sign flips: |g| near zero at a step so far
                small = np.zeros_like(bad)
                for g in grads_seen:
                    small |= np.abs(g[name]) < 1e-6 * np.abs(g[name]).max()
                assert opt == "adamw" and small[bad].all(), (name, i, float(diff.max()))
                flipped.append((i, name, int(bad.sum())))
        if opt == "adamw":
            for key in ("m", "v"):
                wm = T.unstack_jax_tree(want.opt[key])
                for name, t in state.opt[key].items():
                    _close(t.float().numpy(), wm[name],
                           REL * float(np.abs(wm[name]).max()) + 1e-30, (key, name, i))
        else:
            for name, acc in state.opt["acc"].items():
                node = want.opt["acc"]
                for part in name.split("."):
                    node = node[part]
                for k, t in acc.items():
                    _close(t.numpy(), node[k], REL * float(np.abs(node[k]).max()) + 1e-30,
                           (name, k, i))
    if flipped:
        warnings.warn(f"AdamW sign flips (step, leaf, entries), each |g| < 1e-6 "
                      f"max|g|: {flipped}")


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 5, 6), "b": (5,), "s": (3, 7), "t": ()}
    return {k: (0.5 * rng.standard_normal(s)).astype(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_for_five_steps(moment_dtype):
    p, jstate = _tree(0), None
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jadamw.init(jp, moment_dtype=jnp.dtype(moment_dtype))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tstate = adamw.init(tp, moment_dtype=getattr(torch, moment_dtype))
    for i in range(5):
        g = _tree(10 + i)
        jg, gn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = adamw.clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, 1.0)
        assert abs(float(tn) - float(gn)) <= 1e-6 * float(gn)
        lr = 1e-2 * (i + 1)
        jp, jstate = jadamw.update(jg, jstate, jp, jnp.float32(lr))
        tp, tstate = adamw.update(tg, tstate, tp, torch.tensor(lr, dtype=torch.float32))
        for k in p:
            _close(tp[k].numpy(), np.asarray(jp[k]), 1e-6, (k, i))
            for mk in ("m", "v"):
                _close(tstate[mk][k].float().numpy(), np.asarray(jstate[mk][k], np.float32),
                       1e-6 * max(1e-3, float(np.abs(np.asarray(jstate[mk][k],
                                                                np.float32)).max())), (mk, k, i))
    assert int(tstate["count"]) == 5


def test_adafactor_matches_jax_for_five_steps_with_a_stacked_group():
    """Random leaves, and one JAX leaf (3, 5) that the port holds as three
    (5,) tensors: factored over its stack, its RMS clip over all three."""
    p = _tree(1)
    p["stk"] = (0.5 * np.random.default_rng(2).standard_normal((3, 5))).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    jstate = jada.init(jp)
    names = [f"stk.{i}" for i in range(3)]
    tp = {k: torch.tensor(v) for k, v in p.items() if k != "stk"}
    tp.update({n: torch.tensor(p["stk"][i]) for i, n in enumerate(names)})
    groups = {k: ((), [k]) for k in p if k != "stk"}
    groups["stk"] = ((3,), names)
    tstate = adafactor.init(tp, groups=groups)
    for i in range(5):
        g = _tree(20 + i)
        g["stk"] = np.random.default_rng(30 + i).standard_normal((3, 5)).astype(np.float32)
        tg = {k: torch.tensor(v) for k, v in g.items() if k != "stk"}
        tg.update({n: torch.tensor(g["stk"][j]) for j, n in enumerate(names)})
        jp, jstate = jada.update(jax.tree.map(jnp.asarray, g), jstate, jp, jnp.float32(0.01),
                                 weight_decay=0.1)
        tp, tstate = adafactor.update(tg, tstate, tp, torch.tensor(0.01), weight_decay=0.1,
                                      groups=groups)
        for k in p:
            got = (torch.stack([tp[n] for n in names]) if k == "stk" else tp[k]).numpy()
            _close(got, np.asarray(jp[k]), 2e-6, (k, i))
            for ak, t in tstate["acc"][k].items():
                want = np.asarray(jstate["acc"][k][ak])
                _close(t.numpy(), want, 1e-6 * float(np.abs(want).max()), (k, ak, i))


@pytest.mark.parametrize("kind", ["cosine", "wsd", "constant"])
def test_schedules_match_jax(kind):
    """Every step of three (warmup, total) pairs within 2^-20 lr: a few
    float32 steps of lr (the two libraries' cos and pow may round a last
    bit apart, which 1 + cos near -1 makes large relative to the rate)."""
    lr = 3e-4
    for warmup, total in ((5, 40), (1, 10), (0, 3)):
        jf, tf = jsched(kind, lr, warmup, total), make_schedule(kind, lr, warmup, total)
        for step in range(total + 4):
            want = float(jf(jnp.asarray(step, jnp.int32)))
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 2.0 ** -20 * lr, (kind, step)
        assert float(tf(3)) == float(tf(torch.tensor(3, dtype=torch.int32)))


def test_grad_compress_local_functions_bit_for_bit():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    err = (0.01 * rng.standard_normal((64, 33))).astype(np.float32)
    jq, js = jgc.quantize(jnp.asarray(g))
    tq, ts = grad_compress.quantize(torch.tensor(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and float(ts) == float(js)
    np.testing.assert_array_equal(grad_compress.dequantize(tq, ts).numpy(),
                                  np.asarray(jgc.dequantize(jq, js)))
    want = jgc.compress_residual(jnp.asarray(g), jnp.asarray(err))
    got = grad_compress.compress_residual(torch.tensor(g), torch.tensor(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bufs = grad_compress.init_error_buffers({"w": torch.ones(3, 2)})
    assert bufs["w"].dtype == torch.float32 and not bufs["w"].any()
    # no process group joined: a group of one, JAX's arithmetic at n = 1
    mean, new_err = grad_compress.compressed_psum(torch.tensor(g), torch.tensor(err))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jgc.dequantize(want[0],
                                                                           want[1])))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(want[2]))


def test_smollm_smoke_loss_falls_by_one_in_thirty_steps():
    """tests/test_system.py's training claim, on the port (CPU)."""
    cfg = get_config("smollm-135m", smoke=True)
    tc = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=30, remat=False)
    state = S.TrainState.create(cfg, tc, device="cpu")
    step = S.make_train_step(cfg, tc, device="cpu")
    stream = TokenStream(64, 4, 32, seed=0)  # narrow token range: learnable
    losses = []
    for i in range(30):
        state, m = step(state, stream.batch_at(i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert int(state.step) == 30
