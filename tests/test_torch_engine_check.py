"""Engine selection of the port on the CPU: ``repro_torch.engine.check``
(every op of an engine against ``torch-reference``), the port's ops held
to the JAX package's ``reference`` engine on the same numpy inputs
(kNN indices and distances bit for bit, lookups within the JAX check's
1e-5), and ``edm_run --engine`` / ``--use-kernels`` parsing, conflicting
and printing as the JAX driver's do."""
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengines  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.launch import edm_run as jedm_run  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.core import knn  # noqa: E402
from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.engine.check import TOLERANCES, check_engine, main  # noqa: E402
from repro_torch.launch import edm_run  # noqa: E402

E_MAX, LQ, S, K = 5, 96, 3, 6
BUCKETS, LIB_SIZES = (1, 2, 5), (24, 48, 96)


@pytest.mark.parametrize("name", ["torch-reference", "cuda"])
def test_check_engine_passes_on_the_cpu(name):
    errs = check_engine(name, E_max=E_MAX, Lq=LQ, Lc=LQ, seed=1, device="cpu")
    assert set(errs) == set(TOLERANCES)
    assert all(errs[op] <= TOLERANCES[op] for op in errs)


def test_check_engine_catches_a_wrong_engine(monkeypatch):
    eng = engines.get_engine("cuda")
    real = eng.ccm_lookup
    monkeypatch.setattr(eng, "ccm_lookup",
                        lambda idx, w, Y, segs: real(idx, w, Y, segs) + 1e-3)
    with pytest.raises(AssertionError, match="cuda.ccm_lookup"):
        check_engine("cuda", device="cpu")


def test_check_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_engine("cuda")


def test_check_cli(tmp_path):
    out = main(["--device", "cpu"])
    assert sorted(out) == sorted(engines.available_engines())
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.engine.check", "--engine", "cuda",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, cwd=str(
            __import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("cuda {'knn_tables':"), proc.stdout


# ------------------------------------------- the port's ops against JAX's
@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    V = rng.standard_normal((S, E_MAX, LQ)).astype(np.float32)
    V[0, :, 60:70] = V[0, :, 0:10]  # repeated points: ties
    Y = rng.standard_normal((7, LQ)).astype(np.float32)
    col_ids = rng.permutation(LQ).astype(np.int32)
    return V, Y, col_ids


@pytest.mark.parametrize("name", ["torch-reference", "cuda"])
@pytest.mark.parametrize("op", ["knn_tables", "knn_tables_bucketed",
                                "knn_tables_prefix"])
def test_port_tables_equal_the_jax_reference_engine(inputs, name, op):
    V, _, col_ids = inputs
    eng, jeng = engines.get_engine(name), jengines.get_engine("reference")
    cfg, jcfg = EDMConfig(E_max=E_MAX, engine=name), JaxConfig(E_max=E_MAX)
    kw = {"knn_tables": {}, "knn_tables_bucketed": {"buckets": BUCKETS},
          "knn_tables_prefix": {"buckets": BUCKETS, "lib_sizes": LIB_SIZES}}[op]
    t = torch.as_tensor(V)
    if op == "knn_tables_prefix":
        gi, gd = getattr(eng, op)(t, t, K, exclude_self=True, cfg=cfg,
                                  col_ids=torch.as_tensor(col_ids), **kw)
    else:
        gi, gd = getattr(eng, op)(t, t, K, exclude_self=True, cfg=cfg, **kw)
    for s in range(S):
        v = jnp.asarray(V[s])
        extra = {"col_ids": jnp.asarray(col_ids)} if op == "knn_tables_prefix" else {}
        wi, wd = getattr(jeng, op)(v, v, K, exclude_self=True, cfg=jcfg, **kw,
                                   **extra)
        np.testing.assert_array_equal(gi[s].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd[s].numpy().view(np.int32),
                                      np.asarray(wd).view(np.int32))


@pytest.mark.parametrize("name", ["torch-reference", "cuda"])
def test_port_lookup_equals_the_jax_reference_engine(inputs, name):
    V, Y, _ = inputs
    t = torch.as_tensor(V)
    eng = engines.get_engine(name)
    idx, sqd = eng.knn_tables_bucketed(t, t, K, buckets=BUCKETS, exclude_self=True,
                                       cfg=EDMConfig(E_max=E_MAX, engine=name))
    idx, w = knn.tables_with_weights_bucketed(idx, sqd, BUCKETS)
    segs = ((0, 2), (1, 3), (2, 2))
    got = eng.ccm_lookup(idx, w, torch.as_tensor(Y), segs).numpy()  # (S, 7, Lq)
    jeng = jengines.get_engine("reference")
    t0 = 0
    for b, count in segs:
        for s in range(S):
            want = np.asarray(jeng.ccm_lookup(jnp.asarray(idx[s, b].numpy()),
                                              jnp.asarray(w[s, b].numpy()),
                                              jnp.asarray(Y[t0 : t0 + count])))
            assert np.abs(got[s, t0 : t0 + count] - want).max() <= \
                TOLERANCES["ccm_lookup"]
        t0 += count


# ------------------------------------------------- edm_run's engine flags
def _run(tmp_path, *extra):
    return edm_run.main(["--synthetic", "6x150", "--e-max", "3",
                         "--out", str(tmp_path / "o"), *extra])


@pytest.mark.parametrize("flags,engine", [
    (["--device", "cpu", "--engine", "torch-reference"], "torch-reference"),
    (["--device", "cpu", "--engine", "cuda"], "cuda"),
    (["--platform", "cpu", "--engine", "torch-reference"], "torch-reference"),
    (["--device", "cpu", "--use-kernels"], "cuda"),
    (["--device", "cpu", "--use-kernels", "--engine", "cuda"], "cuda"),
])
def test_edm_run_engine_flags_select_the_engine(tmp_path, capsys, flags, engine):
    summ = _run(tmp_path, *flags)
    out = capsys.readouterr().out
    assert f"engine {engine} on" in out
    meta = json.loads((tmp_path / "o" / "causal_map" / "meta.json").read_text())
    assert meta["engine"] == engine
    deprecated = "note: --use-kernels is deprecated; use --engine cuda"
    assert (deprecated in out) == ("--use-kernels" in flags)
    assert summ["result"].rho.shape == (6, 6)


def test_edm_run_engine_flags_parse_as_the_jax_drivers():
    """Both drivers take the same flags (the engine names are each
    package's own)."""
    for argv in (["--use-kernels"], ["--engine", "reference"]):
        jedm_run.build_parser().parse_args(["--out", "o", *argv])
    for argv in (["--use-kernels"], ["--engine", "torch-reference"]):
        edm_run.build_parser().parse_args(["--out", "o", *argv])
    for parser in (jedm_run.build_parser(), edm_run.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--out", "o", "--engine", "nope"])


def test_use_kernels_conflicts_with_another_engine_as_in_jax(tmp_path, capsys,
                                                            monkeypatch):
    monkeypatch.setattr(sys, "argv", ["edm_run", "--synthetic", "4x120",
                                      "--out", str(tmp_path / "j"),
                                      "--use-kernels", "--engine", "reference"])
    with pytest.raises(SystemExit) as e:
        jedm_run.main()
    assert e.value.code != 0
    jerr = capsys.readouterr().err
    assert "--use-kernels conflicts with --engine reference; drop the " \
        "deprecated flag" in jerr
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, "--device", "cpu", "--use-kernels", "--engine",
             "torch-reference")
    assert e.value.code != 0
    assert "--use-kernels conflicts with --engine torch-reference; drop the " \
        "deprecated flag" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flags,msg", [
    (["--platform", "cpu", "--engine", "cuda"],
     "--engine cuda conflicts with --platform cpu (engine torch-reference)"),
    (["--platform", "cpu", "--use-kernels"],
     "--use-kernels conflicts with --platform cpu (engine torch-reference)"),
    (["--platform", "gpu", "--engine", "torch-reference"],
     "--engine torch-reference conflicts with --platform gpu (engine cuda)"),
])
def test_engine_conflicts_with_a_platform_of_another_engine(tmp_path, capsys,
                                                            flags, msg):
    with pytest.raises(SystemExit) as e:
        _run(tmp_path, *flags)
    assert e.value.code != 0
    assert msg in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
