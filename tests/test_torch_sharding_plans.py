"""The port's sharding plans and activation rules against the reference's
(``repro.sharding``): pure logic, no process group.

Every leaf of all ten architectures' full-size parameter trees (the
reference's ``jax.eval_shape`` of its init; the port's init on ``meta``),
in train, serve and serve-2d mode, on the 16 x 16 and 2 x 16 x 16 grids,
gets the reference's spec; so do the batch, KV-cache and logits specs and
every activation role at the reference's cases. Specs compare in the
canonical form of ``tests/test_sharding_plans.py`` ('data' == ('data',)).
"""

from __future__ import annotations

import functools

import jax
import pytest
torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.sharding import ctx as ref_ctx  # noqa: E402
from repro.sharding import plans as ref_plans  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.sharding import ctx, plans  # noqa: E402
from repro_torch.train import tree  # noqa: E402

torch.set_num_threads(1)

ARCHS = [a for a in configs.ALIASES]
MODES = [("train", "tp"), ("serve", "tp"), ("serve", "2d")]


class FakeMesh:
    """Duck-typed mesh for the reference: plans read .shape, .axis_names."""

    def __init__(self, grid):
        self.shape = grid.shape
        self.axis_names = grid.axis_names
        self.size = grid.size


def _canon(spec):
    return tuple((e,) if isinstance(e, str) else e for e in spec)


def _plans(multi_pod, mode, weights):
    grid = make_production_mesh(multi_pod=multi_pod)
    return (ref_plans.Plan(mesh=FakeMesh(grid), mode=mode,
                           serve_weight_mode=weights),
            plans.make_plan(grid, mode, weights))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference {path: shape}, port {path: shape}) of the full init."""
    shapes = jax.eval_shape(ref_build(ref_configs.get(arch)).init,
                            jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ref = {ref_plans._path_str(p): tuple(x.shape) for p, x in flat}
    leaves, paths = tree.flatten_with_paths(
        build(configs.get(arch)).init(torch.Generator(), device="meta"))
    return ref, {p: tuple(x.shape) for x, p in zip(leaves, paths)}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gets_the_reference_spec(arch):
    ref_shapes, port_shapes = _trees(arch)
    assert port_shapes == ref_shapes
    for multi_pod in (False, True):
        for mode, weights in MODES:
            rp, pp = _plans(multi_pod, mode, weights)
            got = plans.param_shardings(
                pp, {p: torch.empty(s, device="meta")
                     for p, s in port_shapes.items()})
            assert got.keys() == ref_shapes.keys()
            for path, shape in ref_shapes.items():
                want = ref_plans.spec_for_param(rp, path, shape)
                assert _canon(got[path]) == _canon(want), \
                    (arch, multi_pod, mode, weights, path)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_specs_equal_the_reference(multi_pod):
    rp, pp = _plans(multi_pod, "serve", "tp")
    for batch in (1, 2, 16, 32, 128, 256):
        for extra in (1, 2):
            assert _canon(plans.batch_spec(pp, batch, extra)) == \
                _canon(ref_plans.batch_spec(rp, batch, extra))
        for seq, kv in ((32768, 8), (524288, 1), (4096, 2), (100, 16)):
            assert _canon(plans.kv_cache_spec(pp, batch, seq, kv)) == \
                _canon(ref_plans.kv_cache_spec(rp, batch, seq, kv))
        for vocab in (151936, 49155, 256000):
            for with_seq in (True, False):
                for b in (None, batch):
                    assert _canon(plans.logits_spec(pp, vocab, with_seq, b)) \
                        == _canon(ref_plans.logits_spec(rp, vocab, with_seq,
                                                        b))
    assert _canon(plans.tokens_spec(pp)) == _canon(ref_plans.tokens_spec(rp))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shard_seq", [False, True])
def test_activation_rules_equal_the_reference(multi_pod, shard_seq):
    grid = make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data") if multi_pod else ("data",)
    ref = ref_ctx.ActivationRules(mesh=FakeMesh(grid), batch_axes=axes,
                                  shard_seq=shard_seq)
    port = ctx.ActivationRules(mesh=grid, batch_axes=axes,
                               shard_seq=shard_seq)
    for role in (None, "batch", "heads", "vocab", "ff", "expert", "model",
                 "batch_full", "seq"):
        for dim in (1, 2, 8, 16, 32, 56, 128, 256, 512, 4096, 151936):
            assert port.axis_for(role, dim) == ref.axis_for(role, dim), \
                (role, dim)
    with pytest.raises(ValueError):
        port.axis_for("bogus", 16)


def test_placements_of_a_spec():
    """One DTensor placement a mesh dim: a dim over ("pod", "data") is two
    Shard entries, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert plans.placements((None, ("pod", "data"), "model"), Mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert plans.placements(("model", None), Mesh) == (
        Replicate(), Replicate(), Shard(0))
    assert plans.placements((), Mesh) == (Replicate(),) * 3
