"""repro_torch.dist (the spec layer) on the CPU against the JAX package's
``repro.dist``.

The port's parameters are one module a layer; the reference's grouped
layers are stacked on a leading axis, whose spec entry its rules pad
with None.  Each port spec is held against the reference's spec for the
same leaf (found through the model's ``ref_paths``) with that stack
entry dropped.  The reference's functions run on the shapes of its own
``param_shapes`` / ``opt_state_shapes`` / ``cache_shapes`` over
``jax.sharding.AbstractMesh``es; the port's on its ``meta`` models and
caches over its own :class:`~repro_torch.dist.ctx.AbstractMesh`.  All
comparisons are exact (specs are names, not numbers).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as P

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # container has no hypothesis
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import CONFIGS as J_CONFIGS
from repro.configs import DLRM_CONFIGS as J_DLRM
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import SMOKE_CONFIGS as J_SMOKE
from repro.dist import ctx as jctx
from repro.dist import sharding as js
from repro.launch import steps as jsteps
from repro.optim import get_optimizer as j_opt
from repro_torch.configs import (CONFIGS, DLRM_CONFIGS, INPUT_SHAPES,
                                 SMOKE_CONFIGS)
from repro_torch.data.synthetic import WORKLOADS
from repro_torch.dist import ctx, sharding
from repro_torch.dist.ctx import AbstractMesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import backbone, dlrm, whisper
from repro_torch.models.tree import to_ref
from repro_torch.optim import get_optimizer

ARCHS = tuple(CONFIGS)
SMOKE_ARCHS = ("smollm-360m", "llama4-scout-17b-a16e", "falcon-mamba-7b",
               "whisper-large-v3", "recurrentgemma-2b")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_MODELS: dict = {}
_REF: dict = {}


def _table(smoke: bool):
    return (SMOKE_CONFIGS if smoke else CONFIGS), (J_SMOKE if smoke
                                                   else J_CONFIGS)


def _model(arch, smoke):
    """The port's meta model and Adam state of ``arch``."""
    key = (arch, smoke)
    if key not in _MODELS:
        cfg = _table(smoke)[0][arch]
        model = steps.param_shapes(cfg)
        opt = steps.opt_state_shapes(cfg, get_optimizer("adam", 1e-3), model)
        _MODELS[key] = (cfg, model, opt)
    return _MODELS[key]


def _ref(arch, smoke):
    """The reference's parameter and Adam-state shapes of ``arch``."""
    key = (arch, smoke)
    if key not in _REF:
        jcfg = _table(smoke)[1][arch]
        _REF[key] = (jcfg, jsteps.param_shapes(jcfg),
                     jsteps.opt_state_shapes(jcfg, j_opt("adam", 1e-3)))
    return _REF[key]


def _jmesh(name):
    sizes, names = MESHES[name]
    return JMesh(sizes, names)


def _tmesh(name):
    return AbstractMesh(*MESHES[name])


def _paths(model, cfg):
    if isinstance(model, whisper.Whisper):
        return whisper.ref_paths(model, cfg)
    if isinstance(model, dlrm.DLRM):
        return dlrm.ref_paths(model)
    return backbone.ref_paths(model, cfg)


def _at(tree, path, at):
    """The reference's spec at ``path``, its stack entry dropped where
    the leaf is stacked (``at`` not None)."""
    node = tree
    for key in path:
        node = node[key]
    assert isinstance(node, P), (path, node)
    spec = tuple(node)
    if at is not None:
        assert spec[0] is None, (path, spec)
        spec = spec[1:]
    return spec


def _assert_specs_equal(got, want_tree, paths):
    assert len(got) == len(paths)
    for spec, (path, at) in zip(got, paths):
        assert isinstance(spec, sharding.Spec)
        assert spec == _at(want_tree, path, at), (path, spec)


# --------------------------------------------------------------------------
# ctx
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", [1, 4, 16])
def test_attn_mode_matches_reference(arch, size):
    assert ctx.attn_mode(CONFIGS[arch], size) == \
        jctx.attn_mode(J_CONFIGS[arch], size)


def test_attn_mode_selection():
    """The reference's ``TestShardingRules`` cases."""
    assert ctx.attn_mode(CONFIGS["granite-34b"], 16) == "g"     # MQA G=48
    assert ctx.attn_mode(CONFIGS["smollm-360m"], 16) == "seq"   # 5/3 heads
    assert ctx.attn_mode(CONFIGS["yi-9b"], 16) == "seq"         # kv4 g8
    assert ctx.attn_mode(CONFIGS["yi-9b"], 4) == "kv"           # kv4 % 4
    assert ctx.attn_mode(CONFIGS["falcon-mamba-7b"], 16) == "none"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_specs_and_installed_mode_match_reference(arch, mesh):
    want = jctx.qkv_specs(J_CONFIGS[arch], _jmesh(mesh))
    got = ctx.qkv_specs(CONFIGS[arch], _tmesh(mesh))
    assert got == (None if want is None else tuple(tuple(s) for s in want))
    assert ctx.data_axes(_tmesh(mesh)) == jctx.data_axes(_jmesh(mesh))
    try:
        assert ctx.set_attention_specs(CONFIGS[arch], _tmesh(mesh)) == \
            jctx.attn_mode(J_CONFIGS[arch], 16)
    finally:
        ctx.clear()


def test_constrain_qkv_is_the_identity_on_one_card_and_refuses_a_mesh():
    q, k, v = torch.ones(1, 4, 2, 2, 8), torch.ones(1, 4, 2, 8), \
        torch.ones(1, 4, 2, 8)
    assert ctx.constrain_qkv(q, k, v) == (q, k, v)
    cfg = CONFIGS["yi-9b"]
    try:
        ctx.set_attention_specs(cfg, AbstractMesh((1, 1), ("data", "model")))
        out = ctx.constrain_qkv(q, k, v)
        assert all(a is b for a, b in zip(out, (q, k, v)))
        ctx.set_attention_specs(cfg, tmesh.make_production_mesh())
        meta = [t.to("meta") for t in (q, k, v)]
        assert all(a is b for a, b in zip(ctx.constrain_qkv(*meta), meta))
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A14.9, multi-device placement"):
            ctx.constrain_qkv(q, k, v)
    finally:
        ctx.clear()
    assert ctx.constrain_qkv(q, k, v) == (q, k, v)


def test_meshes_describe_the_reference_shapes():
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        want = MESHES["2x16x16" if multi else "16x16"]
        assert (m.sizes, m.axis_names) == want
        assert dict(m.shape) == dict(zip(want[1], want[0]))
        assert m.size == (512 if multi else 256)
    host = tmesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.sizes[1] == 1
    assert host.sizes[0] == max(torch.cuda.device_count(), 1)


# --------------------------------------------------------------------------
# parameters and optimizer state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", [1, 4, 16])
def test_smoke_param_and_opt_specs_match_reference(arch, size):
    cfg, model, opt = _model(arch, True)
    jcfg, jp, jo = _ref(arch, True)
    paths = _paths(model, cfg)
    _assert_specs_equal(sharding.param_specs(model, cfg, model_size=size),
                        js.param_specs(jp, jcfg, model_size=size), paths)
    got = sharding.opt_state_specs(opt, model, cfg, model_size=size)
    want = js.param_specs(jo, jcfg, model_size=size)
    for k in ("mu", "nu"):
        _assert_specs_equal(got[k], want[k], paths)
    assert got["t"] == tuple(want["t"]) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_and_opt_specs_match_reference(arch):
    """Every production config on the 16-wide model axis (the default),
    and on a mesh: the same specs, and something is sharded."""
    cfg, model, opt = _model(arch, False)
    jcfg, jp, jo = _ref(arch, False)
    paths = _paths(model, cfg)
    got = sharding.param_specs(model, cfg)
    _assert_specs_equal(got, js.param_specs(jp, jcfg), paths)
    _assert_specs_equal(
        sharding.param_specs(model, cfg, mesh=_tmesh("2x16x16")),
        js.param_specs(jp, jcfg, mesh=_jmesh("2x16x16")), paths)
    want = js.param_specs(jo, jcfg)
    gopt = sharding.opt_state_specs(opt, model, cfg)
    for k in ("mu", "nu"):
        _assert_specs_equal(gopt[k], want[k], paths)
    assert any(e is not None for s in got for e in s)
    for spec, p in zip(got, model.parameters()):
        assert len(spec) == p.dim()


def _dlrm_model(kind, V, stack=None):
    """A meta DLRM of ``kind``'s shapes over a (V, E) table, or a
    PS-stacked (n_ps, max_rows, E) one with ``stack=(n_ps, max_rows)``."""
    cfg = DLRM_CONFIGS[kind]
    ref = dlrm.init_params(cfg, WORKLOADS[cfg.workload], None, "meta")
    E = cfg.embedding_dim
    rows = (V,) if stack is None else stack

    def t(*shape):
        return torch.empty(shape, device="meta")

    extra = {k: getattr(ref, k) for k in ("cross_w", "cross_b")
             if getattr(ref, k) is not None}
    wide = t(*rows, 1) if ref.wide is not None else None
    return cfg, dlrm.DLRM(cfg, t(*rows, E), [w for w in ref.bottom],
                          [w for w in ref.top], wide=wide, **extra)


@pytest.mark.parametrize("kind", ["wdl-tiny", "dcn-tiny"])
@pytest.mark.parametrize("V,stack", [
    (4400, None),            # 4 workers divide V
    (4402, None),            # they do not: the table replicates
    (4400, (4, 1100)),       # PS-stacked: one PS per data shard
    (4400, (2, 2200)),       # 2 PS: the rows within each PS shard
    (4401, (3, 1467)),       # neither divides: replicated
])
def test_dlrm_specs_match_reference(kind, V, stack):
    cfg, model = _dlrm_model(kind, V, stack)
    paths = _paths(model, cfg)
    tree = to_ref([jax.ShapeDtypeStruct(tuple(p.shape), np.float32)
                   for p in model.parameters()], paths)
    jmesh, mesh = JMesh((4, 1), ("data", "model")), \
        AbstractMesh((4, 1), ("data", "model"))
    for c in (None, cfg):
        jc = None if c is None else J_DLRM[kind]
        _assert_specs_equal(sharding.param_specs(model, c, mesh=mesh),
                            js.param_specs(tree, jc, mesh=jmesh), paths)
        _assert_specs_equal(sharding.param_specs(model, c),
                            js.param_specs(tree, jc), paths)
    # row-wise Adagrad's state: a (rows,) accumulator replicates
    state = get_optimizer("rowwise_adagrad", 1e-2).init(
        list(model.parameters()))
    jstate = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[:-1],
                                                         np.float32), tree)
    _assert_specs_equal(sharding.opt_state_specs(state, model, mesh=mesh),
                        js.param_specs(jstate, mesh=jmesh), paths)
    spec = sharding.param_specs(model, mesh=mesh)[0]
    if stack is None:
        assert spec == (("data", None) if V % 4 == 0 else (None, None))
    else:
        assert spec == {4: ("data", None, None), 2: (None, "data", None),
                        3: (None, None, None)}[stack[0]]


# --------------------------------------------------------------------------
# batches, caches, the exchange, ZeRO-1
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh):
    for name, shape in INPUT_SHAPES.items():
        if shape.kind == "decode":
            continue
        got = sharding.batch_specs(CONFIGS[arch], shape, _tmesh(mesh))
        want = js.batch_specs(J_CONFIGS[arch], J_SHAPES[name], _jmesh(mesh))
        assert set(got) == set(want)
        for k in want:
            assert got[k] == tuple(want[k]), (name, k)


def _cache_pairs(cfg, cache):
    """(port leaf path, reference path, stack index) of every cache
    leaf: backbone layer j in a group at index j // P of
    ``groups/l{j % P}``, a rest layer under ``rest``; whisper's
    self-attention rings at index j of ``self``."""
    out = []
    if isinstance(cache, dict):                         # whisper
        for j, layer in enumerate(cache["self"]):
            out += [(("self", j, k), ("self", k), j) for k in layer]
        return out + [((k,), (k,), None) for k in ("cross_k", "cross_v")]
    n_groups, gkinds, _ = backbone.group_layout(cfg)
    P = len(gkinds)
    for j, layer in enumerate(cache):
        for k in layer:
            if j < n_groups * P:
                out.append(((j, k), ("groups", f"l{j % P}", k), j // P))
            else:
                out.append(((j, k), ("rest", f"l{j - n_groups * P}", k),
                            None))
    return out


def _dict_paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _dict_paths(v, path + (k,))]
    return [path]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_cache_specs_match_reference(arch, mesh, smoke):
    shape = INPUT_SHAPES["decode_32k"]
    cfg, jcfg = _table(smoke)[0][arch], _table(smoke)[1][arch]
    cache = steps.cache_shapes(cfg, shape)
    got = sharding.cache_specs(cfg, cache, _tmesh(mesh), shape.global_batch)
    want = js.cache_specs(jcfg, jsteps.cache_shapes(jcfg, J_SHAPES[
        "decode_32k"]), _jmesh(mesh), shape.global_batch)
    pairs = _cache_pairs(cfg, cache)
    # every leaf of the reference's cache has its port leaves
    assert {theirs for _, theirs, _ in pairs} == set(_dict_paths(want))
    for mine, theirs, at in pairs:
        spec = _get(got, mine)
        assert isinstance(spec, sharding.Spec)
        assert len(spec) == _get(cache, mine).dim()
        assert spec == _at(want, theirs, at), (mine, spec)


@pytest.mark.parametrize("mesh", list(MESHES) + [None])
def test_exchange_specs_match_reference(mesh):
    got = sharding.exchange_specs(None if mesh is None else _tmesh(mesh))
    want = js.exchange_specs(None if mesh is None else _jmesh(mesh))
    assert {k: tuple(v) for k, v in want.items()} == got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["smollm-360m", "llama4-scout-17b-a16e",
                                  "falcon-mamba-7b", "whisper-large-v3"])
def test_zero1_specs_match_reference(arch, mesh):
    cfg, model, opt = _model(arch, False)
    jcfg, _, jo = _ref(arch, False)
    paths = _paths(model, cfg)
    ospecs = sharding.opt_state_specs(opt, model, cfg)
    got = sharding.zero1_specs(ospecs, opt, _tmesh(mesh))
    jm = _jmesh(mesh)
    want = js.zero1_specs(js.param_specs(jo, jcfg), jo, jm)
    gained = 0
    for k in ("mu", "nu"):
        for spec, old, (path, at), t in zip(got[k], ospecs[k], paths,
                                            opt[k]):
            # the reference's rule on the port's per-layer leaf
            assert spec == tuple(js.zero1_specs(
                P(*old), jax.ShapeDtypeStruct(tuple(t.shape), np.float32),
                jm)), (k, path)
            theirs = tuple(_get(want[k], path))
            # the reference's stacked leaf: where its rule took the
            # stack axis (the group count divides the data axes) the
            # port's leaf, which has none, takes its first dim that
            # divides instead; elsewhere the two agree
            if at is None or theirs[0] is None:
                assert spec == (theirs if at is None else theirs[1:]), path
            gained += spec != old
            assert len(spec) == t.dim()
    assert got["t"] == () and gained > 0


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------
def _placements(spec, names):
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for d, e in enumerate(spec):
        for n in (() if e is None else e if isinstance(e, tuple) else (e,)):
            dims[n] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_to_shardings_places_the_reference_specs(arch, mesh):
    """Each spec's DTensor placements are the reference's NamedSharding
    spec, one Shard(dim) or Replicate() per mesh axis; entries naming
    axes the mesh lacks are dropped."""
    cfg, model, _ = _model(arch, False)
    jcfg, jp, _ = _ref(arch, False)
    specs = sharding.param_specs(model, cfg)
    got = sharding.to_shardings(specs, _tmesh(mesh))
    want = js.to_shardings(js.param_specs(jp, jcfg), _jmesh(mesh))
    for pl, (path, at) in zip(got, _paths(model, cfg)):
        kept = _at(jax.tree.map(lambda s: s.spec, want), path, at)
        assert pl == _placements(kept, MESHES[mesh][1]), path
        assert len(pl) == len(MESHES[mesh][0])


def test_to_shardings_drops_axes_the_mesh_lacks():
    from torch.distributed.tensor import Replicate, Shard

    specs = {"x": sharding.Spec((("pod", "data"), None)),
             "y": sharding.Spec(("model",)),
             "z": [sharding.Spec((None, "data"))]}
    got = sharding.to_shardings(specs, _tmesh("16x16"))
    assert got == {"x": (Replicate(), Replicate()),
                   "y": (Replicate(), Shard(0)),
                   "z": [(Shard(1), Replicate())]}
    pod = sharding.to_shardings(specs, _tmesh("2x16x16"))
    assert pod["x"] == (Shard(0), Shard(0), Replicate())
    host = sharding.to_shardings(specs)
    assert host["y"] == (Replicate(), Shard(0))
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# the rank invariant
# --------------------------------------------------------------------------
class TestRankInvariantProperty:
    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, len(SMOKE_ARCHS) - 1), st.integers(0, 4))
    def test_spec_rank_matches_leaf_rank(self, arch_idx, log_model):
        """For every SMOKE arch and any power-of-two model-axis width,
        every parameter, optimizer-state and cache spec has exactly the
        rank of its tensor, and every sharded dim divides."""
        arch = SMOKE_ARCHS[arch_idx]
        size = 2 ** log_model
        cfg, model, opt = _model(arch, True)
        mesh = AbstractMesh((2, size), ("data", "model"))
        for spec, p in zip(sharding.param_specs(model, cfg, mesh=mesh),
                           model.parameters()):
            assert len(spec) == p.dim(), (arch, size, p.shape, spec)
            for dim, e in zip(p.shape, spec):
                assert dim % ctx.axis_size(mesh, e) == 0
        ospecs = sharding.opt_state_specs(opt, model, cfg, model_size=size)
        for spec, t in zip(ospecs["mu"], opt["mu"]):
            assert len(spec) == t.dim()
        cache = steps.cache_shapes(cfg, dataclasses.replace(
            INPUT_SHAPES["decode_32k"], seq_len=64, global_batch=4))
        pairs = []
        sharding.tree_map(lambda _, s, t: pairs.append((s, t)),
                          sharding.cache_specs(cfg, cache, mesh, 4), cache)
        assert pairs
        for spec, t in pairs:
            assert len(spec) == t.dim(), (arch, spec, t.shape)
