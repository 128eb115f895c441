"""Sharding plans for the LM zoo (FSDP / TP / SP / EP): the counterpart of
``repro.sharding.plans``, over DTensor placements.

Rule system (the reference's, unchanged)
----------------------------------------
Parameters are matched by their tree path (joined with "/"). Each rule maps
the *logical roles* of a weight's dims onto mesh axes:

  train mode:  d_in -> fsdp axes ("pod","data"), d_out/heads/experts -> "model"
  serve mode:  weights TP-only over "model" (no per-layer all-gathers at
               decode), or 2-D ("model" + fsdp) when memory requires it.

Every axis assignment is guarded by divisibility: a dim that does not tile
the axis falls back (combined axes -> "data" only -> unsharded). Stacked
leaves (under blocks/periods/enc/dec/tail) carry a leading layer-stack dim
that is never sharded.

A spec is a plain tuple, the ``PartitionSpec``'s counterpart: one entry a
tensor dim, each None (replicated), an axis name, or a tuple of names
(the dim split over those axes, major first). :func:`placements` turns a
spec into DTensor placements on a ``DeviceMesh`` whose dim names are the
axis names: one ``Shard(d)`` or ``Replicate()`` a mesh dim, so a tensor dim
over ("pod", "data") holds two ``Shard(d)`` entries. The plan reads only a
mesh's ``.shape`` (axis name -> size) and ``.axis_names``, so
``launch/mesh.RankGrid`` serves as its mesh.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.train import tree

Spec = Tuple[Any, ...]

_STACK_MARKERS = ("blocks", "periods", "enc", "dec", "tail")

# (path regex, dim-role template). Roles: "fsdp", "model", None.
# Templates apply to the *unstacked* shape (leading layer dim stripped).
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # top-level embeddings / heads
    (r"embed$",                      ("model", "fsdp")),
    (r"lm_head$",                    ("fsdp", "model")),
    (r"pos_dec$",                    (None, "fsdp")),
    # attention projections (dense/moe/hybrid/encdec share names)
    (r"(attn|self_attn|cross_attn)/wq/w$", ("fsdp", "model")),
    (r"(attn|self_attn|cross_attn)/wk/w$", ("fsdp", "model")),
    (r"(attn|self_attn|cross_attn)/wv/w$", ("fsdp", "model")),
    (r"(attn|self_attn|cross_attn)/wo/w$", ("model", "fsdp")),
    (r"(attn|self_attn|cross_attn)/w[qkv]/b$", ("model",)),
    (r"(attn|self_attn|cross_attn)/wo/b$",     (None,)),
    # dense FFN (SwiGLU / GELU-MLP)
    (r"(ffn|mlp|shared)/wi$",        ("fsdp", "model")),
    (r"(ffn|mlp|shared)/wg$",        ("fsdp", "model")),
    (r"(ffn|mlp|shared)/wo$",        ("model", "fsdp")),
    (r"mlp/bi$",                     ("model",)),
    (r"mlp/bo$",                     (None,)),
    # MoE: expert-parallel over "model"
    (r"ffn/router$",                 ("fsdp", None)),
    (r"ffn/w[ig]$",                  ("model", "fsdp", None)),
    (r"ffn/wo$",                     ("model", None, "fsdp")),
    (r"shared_gate$",                (None, None)),
    # xLSTM mLSTM
    (r"w_up$",                       ("fsdp", "model")),
    (r"w_[qkv]$",                    ("fsdp", "model")),
    (r"w_[if]$",                     ("fsdp", None)),
    (r"w_down$",                     ("model", "fsdp")),
    # sLSTM
    (r"w_zifo$",                     ("fsdp", "model")),
    (r"r_zifo$",                     (None, None, None, None)),
    (r"up[12]$",                     ("fsdp", "model")),
    (r"down$",                       ("model", "fsdp")),
    # Griffin / RG-LRU: recurrence width dr is elementwise -> pure TP
    (r"w_[yx]$",                     ("fsdp", "model")),
    (r"w_[ri]gate$",                 ("model", None, None)),
    (r"b_[ri]gate$",                 ("model",)),
    (r"lam$",                        ("model",)),
    (r"w_out$",                      ("model", "fsdp")),
    (r"conv_w$",                     (None, "model")),
)


@dataclasses.dataclass(frozen=True)
class Plan:
    mesh: Any                        # .shape {axis: size}, .axis_names
    mode: str                        # train | serve
    serve_weight_mode: str = "tp"    # tp | 2d (2d: add fsdp axes in serve)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.fsdp_axes

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n


def make_plan(mesh: Any, mode: str, serve_weight_mode: str = "tp") -> Plan:
    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: train or serve")
    return Plan(mesh=mesh, mode=mode, serve_weight_mode=serve_weight_mode)


def _resolve_role(plan: Plan, role: Optional[str], dim: int):
    """Role -> concrete mesh axes with divisibility fallback."""
    if role is None:
        return None
    if role == "model":
        return "model" if dim % plan.axis_size("model") == 0 else None
    if role == "fsdp":
        if plan.mode == "serve" and plan.serve_weight_mode == "tp":
            return None                       # weights stay replicated on fsdp axes
        axes = plan.fsdp_axes
        if dim % plan.axis_size(axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        if "data" in axes and dim % plan.axis_size("data") == 0:
            return "data"
        return None
    raise ValueError(role)


def _drop_reused(axes) -> list:
    """No mesh axis may appear twice in one spec; later dims lose."""
    seen = set()
    cleaned = []
    for a in axes:
        names = (a,) if isinstance(a, str) else (a or ())
        if any(n in seen for n in names):
            cleaned.append(None)
        else:
            seen.update(names)
            cleaned.append(a)
    return cleaned


def spec_for_param(plan: Plan, path_str: str, shape: Sequence[int]) -> Spec:
    stacked = any(f"{m}/" in path_str or path_str.startswith(f"{m}/")
                  for m in _STACK_MARKERS)
    core_shape = tuple(shape[1:]) if stacked and len(shape) > 1 else tuple(shape)

    template = None
    for pat, tmpl in _PARAM_RULES:
        if re.search(pat, path_str) and len(tmpl) == len(core_shape):
            template = tmpl
            break
    if template is None:
        # Generic fallback: last dim -> model, largest other dim -> fsdp.
        if len(core_shape) >= 2:
            template = [None] * len(core_shape)
            template[-1] = "model"
            rest = list(range(len(core_shape) - 1))
            big = max(rest, key=lambda i: core_shape[i])
            template[big] = "fsdp"
            template = tuple(template)
        else:
            template = (None,) * len(core_shape)

    cleaned = _drop_reused(_resolve_role(plan, r, d)
                           for r, d in zip(template, core_shape))
    if stacked and len(shape) > 1:
        cleaned = [None] + cleaned
    return tuple(cleaned)


def param_shardings(plan: Plan, params: Any) -> Dict[str, Spec]:
    """Every leaf's spec, keyed by its path string (``tree``'s rendering,
    the reference's): ``params`` is any tree of objects with ``.shape``."""
    leaves, paths = tree.flatten_with_paths(params)
    return {p: spec_for_param(plan, p, x.shape)
            for x, p in zip(leaves, paths)}


# ----------------------------------------------------------- activation specs

def _batch_axes_for(plan: Plan, batch: int):
    axes = plan.batch_axes
    if batch % plan.axis_size(axes) != 0:
        axes = ("data",) if batch % plan.axis_size("data") == 0 else None
    return axes


def tokens_spec(plan: Plan) -> Spec:
    return (plan.batch_axes, None)


def batch_spec(plan: Plan, batch: int, extra_dims: int = 1) -> Spec:
    """Batch-sharded spec with divisibility fallback (batch=1 cells)."""
    return (_batch_axes_for(plan, batch),) + (None,) * extra_dims


def kv_cache_spec(plan: Plan, batch: int, seq: int, kv_heads: int) -> Spec:
    """(L, B, S, Hkv, hd): batch over data(+pod), sequence over model."""
    s_axis = "model" if seq % plan.axis_size("model") == 0 else None
    return (None, _batch_axes_for(plan, batch), s_axis, None, None)


def logits_spec(plan: Plan, vocab: int, with_seq: bool = True,
                batch: Optional[int] = None) -> Spec:
    v_axis = "model" if vocab % plan.axis_size("model") == 0 else None
    b_axes = (plan.batch_axes if batch is None
              else _batch_axes_for(plan, batch))
    if with_seq:
        return (b_axes, None, v_axis)
    return (b_axes, v_axis)


# ---------------------------------------------------------------- placements

def placements(spec: Spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh`` (its dim names the
    axis names): ``Shard(d)`` on each mesh dim that tensor dim ``d`` is
    split over, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"axis {a!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)
