"""Sharding plans: parameter partition rules + logical activation rules,
the twin of ``repro.sharding.plan``.

A :class:`ShardingPlan` bundles what the dry-run needs to distribute a
model on a mesh:

* ``param_rules`` — ordered (regex, logical_axes) rules matched against a
  parameter's '/'-joined path in the reference's tree; first match wins.
  Logical axes are translated through ``activation_rules`` into mesh axes.
* ``activation_rules`` — logical axis name -> mesh axis (or tuple), used
  both for activations (``repro_torch.sharding.shard``) and parameters.

Presets: ``tp`` (heads, ff, experts and vocab over "model"), ``fsdp``
(the weights' d_model dimension and the optimizer state over "data",
ZeRO-3 style), ``ep`` (experts over "model"), and sequence sharding of the
KV cache over "data" for long-context decode ("kv_seq").

The port's parameters carry no layer axis: ``blocks.3.attn.wq`` is layer 3
of the reference's stacked ``blocks/attn/wq``.  :func:`reference_path`
maps the one to the other, and a rule written for the stacked layout has
its leading ``None`` trimmed, as the reference already tolerates.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.sharding.ctx import MeshAxes, Spec, logical_to_mesh

Rule = Tuple[str, Optional[Tuple[Optional[str], ...]]]

#: The parameter groups the reference stacks on a leading layer axis.
STACKED = ("blocks", "cross_blocks", "dec_cross", "encoder")


def default_activation_rules(multi_pod: bool, fsdp: bool = True,
                             shard_kv_seq: bool = False) -> Dict[str, MeshAxes]:
    data_axes: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, MeshAxes] = {
        "batch": data_axes,
        "embed": None,               # activations keep d_model replicated
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "param_embed": "data" if fsdp else None,   # ZeRO-3 weight shard axis
        "param_vocab": "model",
        "kv_seq": "data" if shard_kv_seq else None,
        "seq": None,
    }
    return rules


# Ordered parameter rules over the reference's paths, e.g. blocks/attn/wq,
# blocks/mlp/wi, blocks/moe/experts_wi.  Every leaf under a stacked group
# carries a leading layer dimension there, never sharded -> None first.
def default_param_rules() -> List[Rule]:
    return [
        # embeddings / unembedding
        (r"embed/table$", ("param_vocab", "param_embed")),
        (r"unembed/kernel$", ("param_embed", "param_vocab")),
        # attention projections (layer-stacked)
        (r"attn/wq$", (None, "param_embed", "heads", None)),
        (r"attn/wk$", (None, "param_embed", "kv_heads", None)),
        (r"attn/wv$", (None, "param_embed", "kv_heads", None)),
        (r"attn/wo$", (None, "heads", None, "param_embed")),
        (r"attn/(bq|bk|bv)$", (None, "kv_heads", None)),
        # dense MLP
        (r"mlp/wi(_gate)?$", (None, "param_embed", "mlp")),
        (r"mlp/wo$", (None, "mlp", "param_embed")),
        # MoE
        (r"moe/router$", (None, "param_embed", "experts")),
        (r"moe/experts_wi(_gate)?$", (None, "experts", "param_embed", None)),
        (r"moe/experts_wo$", (None, "experts", None, "param_embed")),
        (r"moe/shared_wi(_gate)?$", (None, "param_embed", "mlp")),
        (r"moe/shared_wo$", (None, "mlp", "param_embed")),
        # SSM / RWKV blocks: shard the inner channel dim over "model"
        (r"(ssm|rwkv)/.*(w_in|w_gate|wx|w_proj)$", (None, "param_embed", "mlp")),
        (r"(ssm|rwkv)/.*w_out$", (None, "mlp", "param_embed")),
        (r"(ssm|rwkv)/", None),  # small per-channel params: replicate
        # norms, biases, scalars: replicated
        (r"(norm|scale|bias|ln)", None),
    ]


def sanitize_spec(spec: Spec, shape: Tuple[int, ...],
                  mesh_shape: Optional[Dict[str, int]]) -> Spec:
    """Drop sharding on dimensions the mesh cannot divide evenly.

    E.g. 8 KV heads cannot shard 16-way: the entry is cleared and the
    tensor stays replicated on that dim — the dry-run then *shows* the
    cost.
    """
    if mesh_shape is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        prod = 1
        for a in axes:
            prod *= mesh_shape.get(a, 1)
        out.append(entry if prod > 0 and dim % prod == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    activation_rules: Dict[str, MeshAxes]
    param_rules: Tuple[Rule, ...]
    multi_pod: bool = False
    fsdp: bool = True

    def spec_for_path(self, path: str, ndim: int,
                      shape: Optional[Tuple[int, ...]] = None,
                      mesh_shape: Optional[Dict[str, int]] = None) -> Spec:
        for pattern, logical in self.param_rules:
            if re.search(pattern, path):
                if logical is None:
                    return ()
                if len(logical) != ndim:
                    # Rule written for the layer-stacked layout; tolerate
                    # non-stacked params by trimming the leading None.
                    if len(logical) == ndim + 1 and logical[0] is None:
                        logical = logical[1:]
                    else:
                        return ()
                spec = logical_to_mesh(logical, self.activation_rules)
                if shape is not None:
                    spec = sanitize_spec(spec, shape, mesh_shape)
                return spec
        return ()


def make_plan(multi_pod: bool = False, fsdp: bool = True,
              shard_kv_seq: bool = False,
              extra_rules: Sequence[Rule] = ()) -> ShardingPlan:
    return ShardingPlan(
        activation_rules=default_activation_rules(
            multi_pod, fsdp=fsdp, shard_kv_seq=shard_kv_seq
        ),
        param_rules=tuple(extra_rules) + tuple(default_param_rules()),
        multi_pod=multi_pod,
        fsdp=fsdp,
    )


def reference_path(name: str) -> str:
    """A port parameter's name -> its path in the reference's tree:
    ``blocks.3.attn.wq`` -> ``blocks/attn/wq`` (the layer index dropped
    from a stacked group), ``embed.table`` -> ``embed/table``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def mesh_shape_of(mesh) -> Optional[Dict[str, int]]:
    """{axis: size} of a ``DeviceMesh``; a dict passes through."""
    if mesh is None or isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_partition_specs(named: Mapping[str, object], plan: ShardingPlan,
                          mesh=None) -> Dict[str, Spec]:
    """{parameter name: tensor} (a module's ``named_parameters()`` or any
    mapping of shapes) -> {name: spec}.

    With ``mesh`` (a ``DeviceMesh`` or an {axis: size} dict) the specs are
    sanitised for divisibility, as the reference's ``jit`` in/out
    shardings require.
    """
    mesh_shape = mesh_shape_of(mesh)
    specs = {}
    for name, leaf in dict(named).items():
        shape = tuple(leaf.shape)
        specs[name] = plan.spec_for_path(reference_path(name), len(shape),
                                         shape, mesh_shape)
    return specs
