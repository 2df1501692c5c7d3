"""The port's sharding specs against the JAX package's, leaf by leaf, for
all ten architectures at full size: the JAX side from ``eval_shape``
trees, the port's from meta-device modules and caches, both on a
stand-in 16 x 16 ("data", "model") mesh.  Parameter specs (FSDP on and
off, dp_only) keyed by the JAX leaf path, each port parameter's spec its
leaf's without the stacked dims; AdamW and Adafactor optimizer specs;
batch specs; decode-cache specs at decode_32k and long_500k; every
sharded dim divisible by its axes; ``input_specs`` / ``cache_specs``
shapes and dtypes equal JAX's; ``auto_policy``'s FSDP threshold;
placements of a spec; the production mesh refused off a world of 256."""
import os

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import shape_cell as jcell  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import policy as JPOL  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig, shape_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import policy as POL  # noqa: E402


def _jax_opt_specs():
    """JAX's ``launch/dryrun.py::_opt_specs`` (its import sets XLA_FLAGS for
    the dry run's 512 fake devices: put back for this process's children)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _opt_specs
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return _opt_specs


class FakeMesh:
    """tests/test_sharding.py's stand-in production mesh."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}
    size = 256


POLICIES = {"fsdp": dict(fsdp=True), "no_fsdp": dict(fsdp=False),
            "dp_only": dict(dp_only=True)}
_SHAPES: dict = {}


def _shapes(arch):
    if arch not in _SHAPES:
        jc = jconfigs.get_config(arch)
        _SHAPES[arch] = (jax.eval_shape(lambda: JT.init_params(jc, jax.random.PRNGKey(0))),
                         T.LM(get_config(arch), torch.device("meta")))
    return _SHAPES[arch]


def _flat(tree, is_leaf=None) -> dict:
    return {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _is_p(x):
    return isinstance(x, P)


@pytest.mark.parametrize("variant", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_leaf_by_leaf(arch, variant):
    jshapes, model = _shapes(arch)
    jpol = JPOL.ShardingPolicy(mesh=FakeMesh(), **POLICIES[variant])
    pol = POL.ShardingPolicy(mesh=FakeMesh(), **POLICIES[variant])
    try:
        want = _flat(JPOL.param_specs(jpol, jshapes), _is_p)
    except KeyError:
        # JAX's MoE rule sizes the model axis, which dp_only sets to None
        # (axis_size(None)): the port's rule fails the same way
        assert variant == "dp_only" and get_config(arch).n_experts > 0
        with pytest.raises(KeyError):
            POL.leaf_specs(pol, model)
        return
    got = POL.leaf_specs(pol, model)
    assert set(got) == set(want)
    for key, spec in got.items():
        assert P(*spec) == want[key], (key, spec, want[key])
    # a port parameter's spec: its leaf's without the leading stacked dims
    per_param = POL.param_specs(pol, model)
    for key, (stack, names) in T.jax_leaf_groups(model).items():
        for name in names:
            assert per_param[name] == got[key][len(stack):], name
            assert len(per_param[name]) == model.get_parameter(name).ndim
    # every sharded dim divides its axes
    jflat = _flat(jshapes)
    for key, spec in got.items():
        for dim, ax in zip(jflat[key].shape, spec):
            if ax is not None:
                assert dim % pol.axis_size(ax) == 0, (key, jflat[key].shape, spec)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b", "zamba2-7b"])
def test_opt_specs_equal_jax(arch, optimizer):
    jshapes, model = _shapes(arch)
    jpol = JPOL.ShardingPolicy(mesh=FakeMesh(), fsdp=True)
    pol = POL.ShardingPolicy(mesh=FakeMesh(), fsdp=True)
    jtc, tc = JTrainConfig(optimizer=optimizer), TrainConfig(optimizer=optimizer)
    jp = JPOL.param_specs(jpol, jshapes)
    want = _jax_opt_specs()(jpol, jp, jshapes, jtc)
    got = POL.opt_specs(pol, POL.param_specs(pol, model), model, tc)
    assert P(*got["count"]) == want["count"]
    if optimizer == "adamw":
        leaves = POL.leaf_specs(pol, model)
        for key in ("m", "v"):
            wflat = _flat(want[key], _is_p)
            for name, spec in got[key].items():  # the moment's leaf is the param's
                leaf = next(k for k, (_, ns) in T.jax_leaf_groups(model).items()
                            if name in ns)
                assert P(*leaves[leaf]) == wflat[leaf]
                assert spec == POL.param_specs(pol, model)[name]
    else:
        wflat = _flat(want["acc"], _is_p)
        gflat = {f"{k}.{part}": s for k, d in got["acc"].items() for part, s in d.items()}
        assert set(gflat) == set(wflat)
        for key, spec in gflat.items():
            assert P(*spec) == wflat[key], key


@pytest.mark.parametrize("cell", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_jax(arch, cell):
    jc, cfg = jconfigs.get_config(arch), get_config(arch)
    jcl, cl = jcell(cell), shape_cell(cell)
    if not configs.cell_applicable(cfg, cl)[0]:
        assert not jconfigs.cell_applicable(jc, jcl)[0]
        return
    jcache = jconfigs.cache_specs(jc, jcl)
    cache = configs.cache_specs(cfg, cl)
    jflat, flat = _flat(jcache), _flat_torch(cache)
    assert set(jflat) == set(flat)
    for k, t in flat.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jflat[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(jflat[k].dtype), k
    jpol = JPOL.ShardingPolicy(mesh=FakeMesh(), fsdp=False)
    pol = POL.ShardingPolicy(mesh=FakeMesh(), fsdp=False)
    want = _flat(JPOL.cache_specs_tree(jpol, jcache, jc), _is_p)
    got = _flat_torch(POL.cache_specs_tree(pol, cache, cfg))
    for k, spec in got.items():
        assert P(*spec) == want[k], (k, spec, want[k])
        for dim, ax in zip(flat[k].shape, spec):
            if ax is not None:
                assert dim % pol.axis_size(ax) == 0, (k, flat[k].shape, spec)
    # the cell's inputs, and their batch specs (dp_only: batch on both axes)
    for kind in ("prefill_32k", cell):
        jin, tin = jconfigs.input_specs(jc, jcell(kind)), configs.input_specs(cfg,
                                                                              shape_cell(kind))
        assert set(jin) == set(tin)
        for k, t in tin.items():
            assert tuple(t.shape) == tuple(jin[k].shape)
            assert str(t.dtype).removeprefix("torch.") == str(jin[k].dtype), k
        for variant in ("fsdp", "dp_only"):
            jb = JPOL.batch_specs(JPOL.ShardingPolicy(mesh=FakeMesh(), **POLICIES[variant]),
                                  jin, "x")
            tb = POL.batch_specs(POL.ShardingPolicy(mesh=FakeMesh(), **POLICIES[variant]),
                                 tin, "x")
            for k in tin:
                assert P(*tb[k]) == jb[k], (kind, variant, k)


def _flat_torch(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_torch(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b", "minicpm-2b", "dbrx-132b"])
def test_auto_policy_fsdp_threshold_and_param_count(arch):
    jc = jconfigs.get_config(arch)
    want = JPOL.estimate_params(jc)
    assert POL.estimate_params(get_config(arch)) == want
    assert POL.auto_policy(get_config(arch), FakeMesh()).fsdp == (want > 2_000_000_000)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.place import placements

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert placements((None, "model"), Mesh()) == [Replicate(), Shard(1)]
    assert placements(("data", "model"), Mesh()) == [Shard(0), Shard(1)]
    assert placements((("data", "model"), None), Mesh()) == [Shard(0), Shard(0)]
    assert placements((), Mesh()) == [Replicate(), Replicate()]


def test_production_mesh_is_refused_off_a_world_of_256():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="exactly 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="exactly 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_a_policy_degrades_to_replication_where_the_axis_does_not_divide():
    cfg = get_config("smollm-135m", smoke=True)
    model = T.LM(cfg, torch.device("meta"))

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 5}

    specs = POL.param_specs(POL.ShardingPolicy(mesh=Mesh(), fsdp=True), model)
    # d 48 on data (2) divides; the model axis (5) divides none of 48, 144, 128, 512
    assert specs["blocks.0.attn.wq.w"] == ("data", None)
    assert specs["embed.tok"] == (None, "data")
    assert all("model" not in s for s in specs.values())


def test_sharding_ctx_is_a_no_op_outside_and_on_plain_tensors():
    from repro_torch.sharding import ctx

    x = torch.ones((4, 8, 2))
    assert ctx.current_policy() is None
    assert ctx.constrain(x, ("data", None, None)) is x
    assert ctx.constrain_seq_parallel(x, seq_axis=1) is x
    pol = POL.ShardingPolicy(mesh=FakeMesh(), dp_only=True)
    with ctx.sharding_ctx(FakeMesh(), pol):
        assert ctx.current_policy() is pol
        assert ctx.constrain_seq_parallel(x, seq_axis=1) is x  # dp_only: batch only
        assert ctx.constrain(x, ("data", None, None)) is x  # not a DTensor
    assert ctx.current_policy() is None
