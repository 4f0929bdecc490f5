"""Tensor and expert parallelism over a mesh's ``model`` axis.

The JAX package gets its model axis from GSPMD: ``param_specs`` places
the weights and XLA inserts the collectives.  The port writes the
partitioned forward and backward itself.  Each rank holds its shard of
every sharded leaf as a plain contiguous tensor (``sharding.specs``:
``model_shard_plan``, ``shard_params``), the kernels take those shards
as they take whole leaves, and every value that crosses the ``model``
axis goes through the mesh's ``model_comm`` (a
:class:`~repro_torch.sharding.collectives.Collectives`, census keys
``"model/..."``), by way of three autograd functions, Megatron's *f* and
*g* and a gather:

  copy_to_model      identity forward, all-reduce of the gradient backward;
  reduce_from_model  all-reduce forward, identity backward;
  gather_from_model  all-gather forward, the rank's own slice backward.

Partial sums are reduced in float32 and rounded to the input's dtype
once, after the sum.  With a ``model`` axis of 1 none of them takes a
collective and the model code runs the unsharded ops.

Which units split is the whole-unit rule (:func:`sharded_units`): an
attention block, a dense FFN, a shared-expert FFN, an MoE expert stack
or a vocab table splits over ``m`` ranks only where the split falls on
whole heads, experts, hidden columns or vocab rows; otherwise the unit's
leaves stay whole on every rank and the unit runs whole there, which
computes the same values.  (GSPMD can also split ``wk``'s columns inside
a head, as ``shard_if_divisible`` allows; explicit code cannot.)
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from repro_torch.utils.tree import map_with_path, tree_leaves

UNITS = ("attn", "ffn", "shared_ffn", "moe", "vocab")

# leaf path -> the unit it belongs to; leaves of no unit (norms, the
# router, biases) are replicated on every rank
_UNIT_RULES = (
    (r"attn/(wq|wk|wv|wo)$", "attn"),
    (r"shared_ffn/(w_gate|w_up|w_down)$", "shared_ffn"),
    (r"(^|/)ffn/(w_gate|w_up|w_down)$", "ffn"),
    (r"moe/(w_gate|w_up|w_down)$", "moe"),
    (r"(^|/)(embed/table|lm_head/w)$", "vocab"),
)

def unit_of(path: str) -> Optional[str]:
    """The unit a leaf path belongs to, or None."""
    for pat, unit in _UNIT_RULES:
        if re.search(pat, path):
            return unit
    return None


def sharded_units(cfg, sizes) -> dict:
    """The whole-unit rule: {unit: whether it splits over the ``model``
    axis of a mesh of ``sizes`` (axis name -> size)}.  Reads the
    config's shapes only.  Raises for a family whose step has no model
    axis yet."""
    m = sizes.get("model", 1)
    out = dict.fromkeys(UNITS, False)
    if m == 1:
        return out
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a 'model' axis of {m}: the "
            "Mamba, hybrid and whisper steps there are ROADMAP item 9b")
    out["attn"] = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    if cfg.moe is None:
        out["ffn"] = cfg.d_ff % m == 0
    else:
        moe = cfg.moe
        out["moe"] = (moe.n_experts if moe.shard_mode == "expert"
                      else moe.d_ff_expert) % m == 0
        if moe.n_shared_experts:
            out["shared_ffn"] = (moe.n_shared_experts
                                 * moe.d_ff_expert) % m == 0
    out["vocab"] = cfg.vocab_padded % m == 0
    return out


class TensorParallel:
    """What the model code needs of the ``model`` axis: its collectives
    (``comm``, None off the mesh), this rank's place on it and which
    units split (:func:`sharded_units`)."""

    def __init__(self, comm, units: dict):
        self.comm = comm
        self.units = dict(units)
        self.size = 1 if comm is None else comm.size
        self.rank = 0 if comm is None else comm.rank

    @classmethod
    def from_mesh(cls, mesh, cfg) -> "TensorParallel":
        return cls(mesh.model_comm, sharded_units(cfg, mesh.shape))

    def on(self, unit: str) -> bool:
        """Whether ``unit`` runs split over more than one rank."""
        return self.size > 1 and self.units[unit]

    def sharded_leaves(self, tree) -> list:
        """For each leaf of a params-like tree (a gradient tree, say), in
        ``tree_leaves`` order: whether this rank holds only a shard."""
        def one(path, leaf):
            unit = unit_of(path)
            return unit is not None and self.on(unit)
        return tree_leaves(map_with_path(one, tree))


def _on(tp: Optional[TensorParallel]) -> bool:
    return tp is not None and tp.size > 1


# ------------------------------------------------------- autograd pair
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, what, *xs):
        ctx.comm, ctx.what = comm, what
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=torch.float32, device=d) if g is None
              else g.float() for g, (s, _, d) in zip(gs, ctx.meta)]
        summed = ctx.comm.all_reduce_tree(gs, ctx.what)
        return (None, None) + tuple(
            s.to(dt) for s, (_, dt, _) in zip(summed, ctx.meta))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, what):
        buf = x.to(torch.float32, copy=True).contiguous()
        return comm._all_reduce_(buf, what).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, what, dim):
        ctx.rank, ctx.dim, ctx.k = comm.rank, dim, x.shape[dim]
        out = comm.all_gather(x.movedim(dim, 0), what)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(),
                None, None, None)


def copy_to_model(tp: Optional[TensorParallel], *xs,
                  what: str = "act_grad"):
    """Each of ``xs`` as it is, whose gradients, partial on each rank
    (each holds its shard's part), are summed over the ``model`` axis in
    one float32 all-reduce.  Returns one tensor for one input, else a
    tuple."""
    if _on(tp):
        xs = _CopyToModel.apply(tp.comm, what, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def reduce_from_model(tp: Optional[TensorParallel], x, what: str):
    """The sum over the ``model`` axis of each rank's partial ``x``, taken
    in float32 and rounded to ``x``'s dtype once; the gradient passes
    through as it is (it is the same on every rank)."""
    if not _on(tp):
        return x
    return _ReduceFromModel.apply(x, tp.comm, what)


def gather_from_model(tp: Optional[TensorParallel], x, what: str,
                      dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient of this rank's slice is its own slice of the gradient."""
    if not _on(tp):
        return x
    return _GatherFromModel.apply(x, tp.comm, what, dim % x.dim())


def global_norm(grads, tp: Optional[TensorParallel] = None):
    """The global L2 norm of a gradient tree whose sharded leaves (on a
    model axis) hold this rank's shard: their squares are summed over
    the axis in one all-reduce, the replicated leaves' counted once.
    Off the axis every leaf is replicated: the unsharded arithmetic."""
    leaves = tree_leaves(grads)
    flags = (tp.sharded_leaves(grads) if _on(tp)
             else [False] * len(leaves))
    sq = lambda g: torch.sum(torch.square(g.float()))
    shard = [sq(g) for g, f in zip(leaves, flags) if f]
    norm2 = sum(sq(g) for g, f in zip(leaves, flags) if not f)
    if shard:
        norm2 = norm2 + tp.comm.all_reduce(sum(shard), "grad_norm")
    return torch.sqrt(norm2)
