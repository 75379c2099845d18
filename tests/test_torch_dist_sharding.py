"""The sharded LM's rules (A12.7) against ``repro.dist``: parameter specs,
cache and batch specs, the activation constraints' drop rules.

* Every parameter's spec of all ten configs at full width (the reference's
  shapes from ``jax.eval_shape``, the port's model on ``meta``) equals the
  reference's ``param_specs`` + ``enforce_divisibility`` with the stacking
  entry of a stacked leaf dropped, on meshes (2, 4), (16, 16) and
  (2, 16, 16), ``fsdp_over_pods`` both ways.  The reference's functions
  are pure: they get a stub mesh carrying ``shape`` and ``axis_names``;
  the port's take the axis sizes.
* ``cache_specs`` and ``batch_spec`` likewise, on the reduced configs'
  caches.
* ``constrain`` on a fake process group of 512 ranks (meta DTensors): the
  placements it gives equal the reference's spec after its drop rules
  (duplicate, absent and indivisible axes), on the three meshes; outside
  ``activation_sharding`` and on a plain tensor it returns its input.
* ``placements`` and ``shard_model`` (each parameter a DTensor whose
  local shard is its shape divided by its spec's axes).
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.dist import constrain as ref_constrain  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import constrain as cst  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.lm import model  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lm_parity import port_leaf_names  # noqa: E402

MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass
class Stub:
    """What the reference's pure functions read of a mesh."""
    shape: dict

    @property
    def axis_names(self):
        return tuple(self.shape)


def _ref_shapes(arch):
    rcfg = ref_configs.get_config(arch)
    return rcfg, jax.eval_shape(
        lambda: ref_model.init_params(rcfg, jax.random.PRNGKey(0)))


_SHAPES = {}


def _shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = _ref_shapes(arch)
    return _SHAPES[arch]


def _is_spec(x):
    return isinstance(x, P)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_references_at_full_width(arch):
    rcfg, shapes = _shapes(arch)
    cfg = configs.get_config(arch)
    m = model.LM(cfg, device="meta")
    params = dict(m.named_parameters())
    for fsdp in (False, True):
        raw_ref = ref_shd.param_specs(shapes, fsdp_over_pods=fsdp)
        raw_port = shd.param_specs(m, fsdp)
        for mname, sizes in MESHES.items():
            ref = ref_shd.enforce_divisibility(shapes, raw_ref, Stub(sizes))
            port = shd.param_specs(m, fsdp, mesh=sizes)
            pairs = port_leaf_names(jax.tree.map(
                lambda s, r, a: (tuple(s), tuple(r), a.shape), ref, raw_ref,
                shapes, is_leaf=_is_spec), rcfg)
            assert sorted(n for n, _, _ in pairs) == sorted(params)
            for name, (spec, raw, shape), stacked in pairs:
                k = int(stacked)
                assert tuple(params[name].shape) == tuple(shape[k:]), name
                assert port[name] == spec[k:], (mname, fsdp, name)
                assert raw_port[name] == raw[k:], (fsdp, name)


def test_logical_axes_drop_the_stacking_entry():
    cfg = configs.get_config("deepseek_v2_lite_16b")
    la = shd.logical_axes(model.LM(cfg, device="meta"))
    assert la["layers.3.chan.gate"] == ("experts", "embed", "ff")
    assert la["layers.0.mix.q.w"] == ("embed", "heads")
    assert la["embed.hot"] == (None, "embed_fsdp")
    assert la["final_norm.scale"] == ("embed",)
    assert la["layers.0.norm1.scale"] == ("embed",)


def _ref_cache_names(tree, cfg):
    plen = len(cfg.layer_pattern())
    out = {}
    for slot, layer in enumerate(tree["periods"]):
        for k, v in layer.items():
            for p in range(cfg.n_layers // plen):
                out[(p * plen + slot, k)] = (v, True)
    base = (cfg.n_layers // plen) * plen
    for i, layer in enumerate(tree.get("tail", ())):
        for k, v in layer.items():
            out[(base + i, k)] = (v, False)
    for k in ("cross_k", "cross_v"):
        if k in tree:
            out[k] = (tree[k], False)
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_batch_specs_equal_the_references(arch):
    rcfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    b, max_len = 32, 16
    shapes = jax.eval_shape(lambda: ref_model.init_cache(rcfg, b, max_len))
    cache = model.init_cache(cfg, b, max_len, device="meta")
    for mname, sizes in MESHES.items():
        stub = Stub(sizes)
        assert shd.batch_spec(sizes) == ref_shd.batch_spec(stub)
        ref = ref_shd.enforce_divisibility(
            shapes, ref_shd.cache_specs(shapes, stub), stub)
        port = shd.cache_specs(cache, sizes)
        want = _ref_cache_names(jax.tree.map(
            lambda s, a: (tuple(s), a.shape), ref, shapes, is_leaf=_is_spec),
            rcfg)
        got = {(i, k): (port["layers"][i][k], cache["layers"][i][k])
               for i in range(cfg.n_layers) for k in cache["layers"][i]}
        got.update({k: (port[k], cache[k]) for k in ("cross_k", "cross_v")
                    if k in cache})
        assert set(got) == set(want)
        for key, (spec, t) in got.items():
            (rspec, rshape), stacked = want[key]
            k = int(stacked)
            assert tuple(t.shape) == tuple(rshape[k:]), key
            enforced = shd.enforce_divisibility(t.shape, spec, sizes)
            assert enforced == rspec[k:], (mname, key)
        assert port["len"] == () and tuple(ref["len"]) == ()


# ---------------------------------------------------------------- DTensor
@pytest.fixture(scope="module")
def fake512():
    """This process as rank 0 of a fake group of 512 ranks, for the
    module's DTensor tests; destroyed after them."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _mesh(sizes):
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(list(sizes.values())))
    return DeviceMesh("cpu", torch.arange(n).reshape(*sizes.values()),
                      mesh_dim_names=tuple(sizes))


def _spec_of(x):
    """The spec a DTensor's placements give (entries in mesh order)."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.dim())]
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


CONSTRAIN_CASES = [
    ((64, 128, 32, 16), ("batch", None, "model", None)),
    ((64, 128, 12, 16), ("batch", None, "model", None)),   # 12 % 16
    ((64, 128, 12, 16), ("batch", "seq", None, None)),
    ((3, 128, 32, 16), ("batch", None, "model", None)),    # batch 3
    ((64, 128, 32), ("batch", "model", "model")),          # duplicate
    ((64, 128, 32), ("pod", "data", None)),                # absent on 2-D
    ((8, 64, 2048), ("batch", None, "model")),             # logits
    ((4, 64, 128), (None, "batch", "model")),              # MoE panels
    ((64, 128, 32), (None, None, None)),                   # nothing named
]


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_constrain_follows_the_references_drop_rules(fake512, mname):
    from torch.distributed.tensor import Replicate, distribute_tensor

    sizes = MESHES[mname]
    mesh = _mesh(sizes)
    for shape, axes in CONSTRAIN_CASES:
        x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                              [Replicate()] * mesh.ndim)
        with ref_constrain.activation_sharding(tuple(sizes), sizes):
            raw = P(*(ref_constrain._resolve(n) or None
                      for _, n in zip(shape, axes)))
            want = tuple(ref_shd._enforce_one(shape, raw, sizes))
        with cst.activation_sharding(mesh):
            y = cst.constrain(x, *axes)
            assert cst.axis_size("model") == sizes["model"]
            assert cst.axis_size("batch") == sizes["data"] * sizes.get("pod", 1)
        if all(e is None for e in want):
            assert y is x, (shape, axes)
        else:
            assert _spec_of(y) == want, (mname, shape, axes)
    # outside the context, and on a plain tensor: the input itself
    x = distribute_tensor(torch.empty(64, 128, 32, device="meta"), mesh,
                          [Replicate()] * mesh.ndim)
    assert cst.constrain(x, "batch", None, "model") is x
    assert cst.axis_size("model") == 0
    plain = torch.ones(64, 128, 32)
    with cst.activation_sharding(mesh):
        assert cst.constrain(plain, "batch", None, "model") is plain


def test_placements_and_shard_model(fake512):
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(MESHES["2x16x16"])
    assert shd.placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None,), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        shd.placements((("data", "pod"),), mesh)
    cfg = configs.get_config("yi_9b")
    m = model.LM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    specs = shd.shard_model(m, mesh, fsdp_over_pods=True)
    sizes = shd.mesh_shape(mesh)
    for name, p in m.named_parameters():
        local = tuple(p.to_local().shape)
        want = tuple(
            d // int(np.prod([sizes[a] for a in shd._axes_tuple(e)]))
            for d, e in zip(shapes[name], specs[name]))
        assert local == want and tuple(p.shape) == shapes[name], name
        assert _spec_of(p) == specs[name]
    assert specs["embed.hot"] == (None, ("pod", "data"))
    assert specs["layers.0.mix.k.w"] == (("pod", "data"), "model")
    assert specs["layers.0.norm1.scale"] == (("pod", "data"),)


def test_meshes_clamp_to_the_world_and_default_to_cuda(fake512):
    from repro_torch.launch import mesh as mesh_mod

    m = mesh_mod.make_production_mesh(device="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (16, 16)
    m = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert tuple(m.shape) == (2, 16, 16)
    # the reference's clamp: data to the world, model to what is left
    for data, model, want in ((4, 8, (4, 8)), (1024, 4, (512, 1)),
                              (32, 64, (32, 16))):
        assert tuple(mesh_mod.make_host_mesh(data, model,
                                             device="cpu").shape) == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_host_mesh(1, 1)
