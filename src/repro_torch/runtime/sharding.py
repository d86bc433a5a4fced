"""Per-architecture sharding policy over a device mesh, the twin of
``repro.runtime.sharding``, with ``torch.distributed`` DTensor placements
in place of JAX's ``NamedSharding``.

Mesh axes: ("data", "model") single-pod 16x16, ("pod", "data", "model")
multi-pod 2x16x16. The "pod" axis is pure data parallelism; "data" carries
batch (plus FSDP weight sharding for the largest models); "model" carries
tensor parallelism.

The placement rules are the JAX package's, rule for rule:
  * q-heads sharded on "model" when H % model_size == 0 ("heads" mode),
    otherwise row-parallel d_model contraction ("dmodel" mode, e.g. gemma3
    with H=8 < 16);
  * GQA k/v projections replicate when G < model_size (they are small);
    decode KV caches shard on sequence when divisible, else on head_dim;
  * MLP hidden / MoE d_ff / vocab dims shard on "model";
  * FSDP: when bf16 params / model_size exceed 4 GiB a card, weight tensors
    additionally shard their d_model/vocab dim over "data" (grok-1, dbrx,
    internvl2);
  * SSM heads (mamba/rwkv) shard on "model" via activation constraints.

A spec (``P``) holds one entry a tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of names that shard the one
dimension over several mesh axes, major to minor as in JAX. ``placements``
turns a spec into DTensor placements for a mesh: ``Shard(dim)`` on each mesh
dimension whose name the spec holds, ``Replicate()`` on the others. The
policy reads only the mesh's names and sizes, so tests build it on an
``AbstractMesh`` with no process group.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..tree import tree_map, tree_map_with_path

FSDP_THRESHOLD_BYTES = 4 << 30  # per-card bf16 param budget before FSDP


class P:
    """A partition spec: one entry a tensor dimension. A one-name tuple entry
    is stored as the name, as ``jax.sharding.PartitionSpec`` stores it. Not a
    tuple, so that the tree walkers take a spec for a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


@dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and sizes only (the twin of JAX's
    ``AbstractMesh``)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """The device a ``DeviceMesh``'s local shards lie on: the CPU, or this
    process's current card."""
    if isinstance(mesh, AbstractMesh):
        raise ValueError("an AbstractMesh has no devices; run on a DeviceMesh")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_axis_names(mesh) -> tuple:
    return mesh.axis_names if isinstance(mesh, AbstractMesh) else tuple(mesh.mesh_dim_names)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(i)`` where tensor dimension i names it, else ``Replicate()``. A
    mesh dimension of size 1 replicates (the same layout; DTensor refuses
    views that merge a dimension "sharded" one way, JAX does not)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    out = []
    for name in mesh_axis_names(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and sizes[name] > 1 else Replicate())
    return tuple(out)


def divides(mesh, spec, shape) -> P:
    """``spec`` with every entry whose mesh axes do not divide its dimension
    (or that lies past ``shape``) replaced by None."""
    sizes = mesh_shape(mesh)
    fixed = []
    for i, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        n = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        fixed.append(ax if i < len(shape) and shape[i] % n == 0 else None)
    return P(*fixed)


@dataclass
class ShardingPolicy:
    cfg: ArchConfig
    mesh: Any  # DeviceMesh or AbstractMesh
    batch_axes: tuple  # ("data",) or ("pod", "data")
    attn_mode: str  # "heads" | "dmodel"
    fsdp: bool
    model_size: int

    # ---------------------------------------------------------------- specs --
    def param_spec(self, path: str, shape: tuple) -> P:
        """Spec for one parameter. Per-layer stacks under ``blocks/`` carry a
        leading layer dim: compute the spec on the unstacked shape, then
        prepend a replicated axis."""
        if "blocks/" in path and len(shape) >= 1:
            base = self._param_spec_base(path, shape[1:])
            return P(None, *base)
        return self._param_spec_base(path, shape)

    def _param_spec_base(self, path: str, shape: tuple) -> P:
        M = self.model_size
        fsdp_ax = "data" if self.fsdp else None

        def fs(dim_size):  # fsdp axis only if divisible
            return fsdp_ax if fsdp_ax and dim_size % self._data_size == 0 else None

        if path.endswith("embed"):
            return P("model", fs(shape[-1]))
        if path.endswith("lm_head"):
            return P(fs(shape[0]), "model")
        if path.endswith("patch_proj"):
            return P(None, "model")
        if re.search(r"attn/wq$", path):
            H = shape[-2]
            if self.attn_mode == "heads" and H % M == 0:
                return P(fs(shape[0]), "model", None)
            return P("model", None, None)  # row-parallel
        if re.search(r"attn/w[kv]$", path):
            G = shape[-2]
            if self.attn_mode == "heads" and G % M == 0:
                return P(fs(shape[0]), "model", None)
            if self.attn_mode == "heads":
                return P(fs(shape[0]), None, None)  # small: replicate on model
            return P("model", None, None)
        if re.search(r"attn/wo$", path):
            H = shape[0]
            if self.attn_mode == "heads" and H % M == 0:
                return P("model", None, fs(shape[-1]))
            return P(None, None, "model")
        if re.search(r"(q_norm|k_norm)$", path):
            return P(None)
        if re.search(r"moe/router$", path):
            return P(None, None)
        if re.search(r"moe/w_(in|gate)$", path):
            return P(None, fs(shape[-2]), "model")  # TP over d_ff + FSDP over d
        if re.search(r"moe/w_out$", path):
            return P(None, "model", fs(shape[-1]))
        if re.search(r"mlp/w_(in|gate)$", path) or path.endswith("cm_Wk"):
            return P(fs(shape[-2]), "model")
        if re.search(r"mlp/w_out$", path) or path.endswith("cm_Wv"):
            return P("model", fs(shape[-1]))
        if re.search(r"mamba/w_in$", path):
            return P("model", None)  # row-parallel into the SSD block
        if re.search(r"mamba/w_out$", path):
            return P(None, "model") if shape[-2] % M == 0 else P(None, None)
        if re.search(r"tm/W[rkvg]$", path) or path.endswith("cm_Wr"):
            # column-parallel: output d-sharded == wkv-head-sharded, so the
            # whole time-mix stays local and only Wo's contraction reduces
            return P(None, "model")
        if path.endswith("tm/Wo"):
            return P("model", None)  # row-parallel: consumes d-sharded y*g
        if re.search(r"tm/(A_mix|A_w|B_mix|B_w)$", path):
            return P(*([None] * len(shape)))  # tiny LoRA mats: replicate
        # norms, biases, scalars, conv kernels, small vectors: replicated
        return P(*([None] * len(shape)))

    @property
    def _data_size(self) -> int:
        sizes = mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)

    def _validate(self, spec: P, shape: tuple) -> P:
        return divides(self.mesh, spec, shape)

    def param_specs(self, params: Any) -> Any:
        """The tree of specs of a params(-shaped) tree, axes that do not
        divide evenly dropped (JAX's ``params_sharding(...).spec``)."""
        return tree_map_with_path(
            lambda path, x: self._validate(self.param_spec(path, tuple(x.shape)),
                                           tuple(x.shape)), params)

    def params_sharding(self, params: Any) -> Any:
        """The tree of DTensor placements of a params(-shaped) tree."""
        return tree_map(lambda s: placements(self.mesh, s), self.param_specs(params))

    # -------------------------------------------------------------- inputs --
    def batch_spec(self, ndim: int) -> P:
        return P(self.batch_axes, *([None] * (ndim - 1)))

    def input_specs(self, tree: Any) -> Any:
        return tree_map(lambda x: self._validate(self.batch_spec(len(x.shape)),
                                                 tuple(x.shape)), tree)

    def inputs_sharding(self, tree: Any) -> Any:
        return tree_map(lambda s: placements(self.mesh, s), self.input_specs(tree))

    # --------------------------------------------------------------- cache --
    def cache_spec(self, path: str, shape: tuple) -> P:
        M = self.model_size
        leaf_name = path.rsplit("/", 1)[-1]
        if leaf_name in ("k", "v"):  # (L, b, t, G, hd)
            L, b, t, G, hd = shape
            # flash-decoding layout: shard the cache SEQUENCE over "model" —
            # decode then gathers the tiny q instead of the huge cache, and
            # softmax only all-reduces per-row stats
            if t % M == 0:
                return P(None, self.batch_axes, "model", None, None)
            if hd % M == 0:
                return P(None, self.batch_axes, None, None, "model")
            return P(None, self.batch_axes, None, None, None)
        if leaf_name in ("ssm", "wkv"):  # (L, b, H, N|P, P)
            H = shape[2]
            return P(None, self.batch_axes, "model" if H % M == 0 else None, None, None)
        # conv state / shift registers: batch only
        return P(None, self.batch_axes, *([None] * (len(shape) - 2)))

    def cache_specs(self, cache: Any) -> Any:
        return tree_map_with_path(
            lambda path, x: self._validate(self.cache_spec(path, tuple(x.shape)),
                                           tuple(x.shape)), cache)

    def cache_sharding(self, cache: Any) -> Any:
        return tree_map(lambda s: placements(self.mesh, s), self.cache_specs(cache))

    # ---------------------------------------------------- activation policy --
    def activation_specs(self) -> dict:
        B = self.batch_axes
        # sequence parallelism on the residual stream: constrain() drops the
        # "model" axis where seq does not divide (decode steps). Token-shift
        # families (rwkv) read x[t-1], so their residuals stay seq-replicated.
        sp_ax = None if self.cfg.family == "ssm" else "model"
        specs = {
            "emb": P(B, sp_ax, None),
            "residual": P(B, sp_ax, None),
            "logits": P(B, None, "model"),
            "ffn_hidden": P(B, None, "model"),
            "moe_dispatch": P(B, None, None, None),
            "moe_expert_in": P(B, None, None, None),
            "moe_hidden": P(B, None, None, "model"),
            "moe_expert_out": P(B, None, None, "model"),
            "decode_scores": P(B, None, None, "model"),
        }
        if self.attn_mode == "heads":
            specs["attn_q"] = P(B, None, "model", None)
            specs["attn_out"] = P(B, None, "model", None)
            specs["attn_chunk"] = P(None, B, "model", None, None)
        if self.cfg.family in ("ssm", "hybrid"):
            H = (self.cfg.ssm_heads if self.cfg.family == "hybrid"
                 else self.cfg.d_model // self.cfg.ssm_head_dim)
            if H % self.model_size == 0:
                specs["ssm_x"] = P(B, None, "model", None)
                specs["wkv_state"] = P(B, None, "model", None, None)
        return specs


def make_policy(cfg: ArchConfig, mesh) -> ShardingPolicy:
    axes = mesh_axis_names(mesh)
    sizes = mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    model_size = sizes["model"]
    attn_mode = "heads" if cfg.num_heads % model_size == 0 else "dmodel"
    params_bf16 = cfg.param_count() * 2
    fsdp = params_bf16 / model_size > FSDP_THRESHOLD_BYTES
    return ShardingPolicy(cfg=cfg, mesh=mesh, batch_axes=batch_axes, attn_mode=attn_mode,
                          fsdp=fsdp, model_size=model_size)


# ------------------------------------------------------------- placement --
def distribute(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor of
    ``spec`` on ``mesh``: each rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements(mesh, spec), src_data_rank=None)


def shard_params(params: Any, policy: ShardingPolicy) -> Any:
    """``params`` (the same on every rank) as DTensors under ``policy``."""
    return tree_map(lambda x, s: distribute(x, policy.mesh, s), params,
                    policy.param_specs(params))


def shard_cache(cache: Any, policy: ShardingPolicy) -> Any:
    """A decode cache (the same on every rank) as DTensors under ``policy``."""
    return tree_map(lambda x, s: distribute(x, policy.mesh, s), cache,
                    policy.cache_specs(cache))


def gather(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as the whole tensor (a plain tensor);
    other leaves as they are. For checks and checkpoints, never the model."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
