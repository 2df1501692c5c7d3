"""The port's checkpoints, resilient loop and train CLI on the CPU: the
mirrors of tests/test_checkpoint_fault.py's training cases (round trip
bit-exact, a bfloat16 state included; 6 straight steps equal to 3 + crash
+ restore + 3; keep_last; an async save; the resilient loop recovering
from an injected failure and giving up after max_retries; straggler
telemetry), plus the snapshot copy under in-place steps, a retry with
no checkpoint on disk that ends on a clean run's bits (the loop's host
snapshot of the pre-step state) and ``python -m repro_torch.launch.train
--device cpu`` resuming from its own checkpoint."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import TrainState, make_train_step  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime.fault import ResilientLoop, StepTelemetry  # noqa: E402


def _setup(dtype="float32", optimizer="adamw"):
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True), dtype=dtype)
    tc = TrainConfig(remat=False, lr=1e-3, warmup_steps=1, total_steps=20,
                     optimizer=optimizer)
    state = TrainState.create(cfg, tc, device="cpu")
    step = make_train_step(cfg, tc, device="cpu")
    stream = TokenStream(cfg.vocab_size, 2, 16, seed=0)
    return cfg, tc, state, step, stream


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8).numpy()


def _assert_same(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


def _copy(state):
    return {k: v.detach().clone() for k, v in _flatten(state).items()}


@pytest.mark.parametrize("dtype,optimizer", [("float32", "adamw"),
                                             ("bfloat16", "adafactor")])
def test_checkpoint_roundtrip_bitexact(tmp_path, dtype, optimizer):
    _, _, state, step, stream = _setup(dtype, optimizer)
    state, _ = step(state, stream.batch_at(0))
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    ckpt.save(1, state, blocking=True)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["dtypes"]["params.embed.tok"] == dtype
    assert manifest["dtypes"]["step"] == "int32"
    if dtype == "bfloat16":  # stored as its 16-bit patterns
        assert np.load(tmp_path / "step_00000001" / "params.embed.tok.npy").dtype == np.uint16
    restored = ckpt.restore(1, state)
    assert restored.params is not state.params
    _assert_same(state, restored)


def test_kill_and_resume_is_bitexact(tmp_path):
    """train 6 steps straight == train 3, 'crash', restore, train 3 more."""
    _, _, state0, step, stream = _setup()
    ckpt = CheckpointManager(tmp_path / "c", keep_last=2)
    ckpt.save(0, state0, blocking=True)
    sA = state0
    for i in range(6):
        sA, _ = step(sA, stream.batch_at(i))
    sB = ckpt.restore(0, sA)
    for i in range(3):
        sB, _ = step(sB, stream.batch_at(i))
    ckpt.save(3, sB, blocking=True)
    del sB  # "crash"
    step_n, sB = ckpt.restore_latest(sA)
    assert step_n == 3
    for i in range(3, 6):
        sB, _ = step(sB, stream.batch_at(i))
    _assert_same(sA, sB)


def test_keep_last_gc_and_latest(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    tree = {"a": torch.arange(4)}
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree, blocking=True)
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4
    assert not list(tmp_path.glob("tmp_step_*"))


def test_async_save_then_wait(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep_last=1)
    ckpt.save(7, {"w": torch.ones((256, 256))})
    ckpt.wait()
    assert ckpt.latest_step() == 7


def test_async_save_survives_in_place_steps(tmp_path):
    """The snapshot is a copy: steps that write the parameters and moments
    in place while the writer runs do not reach the saved checkpoint."""
    _, _, state, step, stream = _setup()
    state, _ = step(state, stream.batch_at(0))
    before = _copy(state)
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    ckpt.save(1, state)  # in flight
    for i in range(1, 4):
        state, _ = step(state, stream.batch_at(i))
    ckpt.wait()
    restored = _flatten(ckpt.restore(1, state))
    moved = 0
    for k, v in before.items():
        np.testing.assert_array_equal(_bits(restored[k]), _bits(v), err_msg=k)
        moved += not torch.equal(_flatten(state)[k], v)
    assert moved > 0  # the live state did move


def test_resilient_loop_recovers_from_injected_failure(tmp_path):
    _, _, state, step, stream = _setup()
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    ckpt.save(0, state, blocking=True)
    calls = {"n": 0}

    def flaky_step(s, b):
        calls["n"] += 1
        if calls["n"] == 3:  # one transient failure
            raise RuntimeError("simulated preemption")
        return step(s, b)

    sink = telemetry.MemorySink()
    telemetry.configure(sink)
    try:
        loop = ResilientLoop(flaky_step, ckpt, save_every=2, max_retries=2)
        final, step_n, metrics = loop.run(state, stream.batch_at, n_steps=5)
    finally:
        telemetry.configure()
    assert step_n == 5 and np.isfinite(metrics["loss"])
    assert loop.telemetry.n_steps >= 5
    (retry,) = [r for r in sink.records if r["name"] == "step_retry"]
    assert retry["kind"] == "counter" and retry["attrs"]["retry"] == 1
    # the recovery replayed from the step-2 checkpoint: same final state as
    # an uninterrupted run (deterministic stream + bit-exact restore) from
    # the same seeded initial state
    _, _, ref, _, _ = _setup()
    for i in range(5):
        ref, _ = step(ref, stream.batch_at(i))
    _assert_same(ref.params, final.params)


def test_retry_without_a_checkpoint_replays_the_pre_step_state(tmp_path):
    """A step that fails after writing its update, before any checkpoint
    exists (save_every past the run): the loop copies its pre-step host
    snapshot back and retries the same step, so the run ends on a clean
    run's bits -- and on JAX's jitted steps from the same state within
    1e-5 max(1, max |want|)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import steps as JS
    from repro_torch.launch.steps import train_state_from_jax
    from repro_torch.models import transformer as T

    kw = dict(remat=False, lr=1e-3, warmup_steps=1, total_steps=20)
    jc = jget("smollm-135m", smoke=True)
    jstate = JS.TrainState.create(jc, JTrainConfig(**kw), jax.random.PRNGKey(0))
    cfg = get_config("smollm-135m", smoke=True)
    tc = TrainConfig(**kw)
    fresh = lambda: train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, tc,
                                         device="cpu")
    step = make_train_step(cfg, tc, device="cpu")
    stream = TokenStream(cfg.vocab_size, 2, 16, seed=0)
    calls = {"n": 0}

    def fails_after_update(s, b):
        calls["n"] += 1
        out = step(s, b)  # the parameters and moments are written in place
        if calls["n"] == 2:
            raise RuntimeError("simulated failure after the update")
        return out

    loop = ResilientLoop(fails_after_update, CheckpointManager(tmp_path, keep_last=1),
                         save_every=100, max_retries=2)
    final, step_n, _ = loop.run(fresh(), stream.batch_at, n_steps=4)
    assert step_n == 4 and calls["n"] == 5
    assert loop.snapshot.takes == 4  # one a step, none for the retry
    clean = fresh()
    for i in range(4):
        clean, _ = step(clean, stream.batch_at(i))
    _assert_same(clean, final)
    jstep = jax.jit(JS.make_train_step(jc, JTrainConfig(**kw)))
    for i in range(4):
        jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, stream.batch_at(i)))
    want = T.unstack_jax_tree(jax.tree.map(np.asarray, jstate.params))
    for name, p in final.params.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def test_resilient_loop_gives_up_after_max_retries(tmp_path):
    _, _, state, _, stream = _setup()
    ckpt = CheckpointManager(tmp_path, keep_last=1)
    ckpt.save(0, state, blocking=True)
    calls = {"n": 0}

    def always_fails(s, b):
        calls["n"] += 1
        raise RuntimeError("hard failure")

    loop = ResilientLoop(always_fails, ckpt, save_every=10, max_retries=2)
    with pytest.raises(RuntimeError, match="hard failure"):
        loop.run(state, stream.batch_at, n_steps=1)
    assert calls["n"] == 3


def test_straggler_telemetry():
    sink = telemetry.MemorySink()
    telemetry.configure(sink)
    try:
        t = StepTelemetry(threshold=2.0)
        for _ in range(10):
            t.record(1.0)
        assert t.record(5.0) is True
    finally:
        telemetry.configure()
    assert t.n_stragglers == 1
    (rec,) = [r for r in sink.records if r["name"] == "straggler"]
    assert rec["attrs"]["dt_s"] == 5.0


def test_train_cli_resumes_from_its_own_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--smoke", "--batch", "2", "--seq", "32", "--save-every", "3",
            "--log-every", "1", "--device", "cpu", "--ckpt-dir", ck]
    _, step, _ = train.main([*base, "--steps", "6"])
    out = capsys.readouterr().out
    assert step == 6 and "resumed" not in out
    assert out.strip().splitlines()[-1].startswith("done at step 6; final loss ")
    state, step, _ = train.main([*base, "--steps", "9"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "resumed from step 6"
    assert out[1].startswith("step     7 loss=")
    assert out[-1].startswith("done at step 9; final loss ")
    assert step == 9 and int(state.step) == 9
    assert CheckpointManager(ck).all_steps() == [6, 9]


def test_train_cli_refuses_the_production_mesh_and_defaults_to_the_card(tmp_path):
    # the 16 x 16 mesh needs a world of exactly 256 ranks
    with pytest.raises(ValueError, match="exactly 256 ranks"):
        train.main(["--smoke", "--production-mesh", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
