"""Tensor and expert parallelism over a mesh's ``model`` axis, and FSDP
over its ``data`` axis.

The JAX package gets its model axis from GSPMD: ``param_specs`` places
the weights and XLA inserts the collectives.  The port writes the
partitioned forward and backward itself.  Each rank holds its shard of
every sharded leaf as a plain contiguous tensor (``sharding.specs``:
``shard_plan``, ``shard_params``), the kernels take those shards
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

Over ``data`` a leaf whose plan splits it holds this rank's block of
rows (FSDP, the reference's ``data`` spec components): the round
gathers it whole at use (:func:`gather_from_data`, over the mesh's
``data_comm``) and hands each rank its block of the gradient, the
blocks of the sum over ranks when each rank's minibatch differs, its
own slice when the minibatch is replicated.

Which units split is the whole-unit rule (:func:`sharded_units`): an
attention block, a dense FFN (SwiGLU or whisper's GELU MLP), a
shared-expert FFN, an MoE expert stack, a Mamba-2 block or a vocab table
splits over ``m`` ranks only where the split falls on whole heads,
experts, hidden columns, SSD heads or vocab rows; otherwise the unit's
leaves stay whole on every rank and the unit runs whole there, which
computes the same values.  A stage model's dense ``lin/w`` (the ``lin``
unit) splits its columns wherever they divide ``m``.

An attention unit with fewer kv heads than ranks (``n_kv_heads < m``,
``m % n_kv_heads == 0``, the query heads dividing ``m``) splits over kv
head groups (:func:`kv_replicas`): rank ``r`` holds its ``n_heads / m``
query heads (its columns of ``wq``, its rows of ``wo``) and the one kv
head they read, ``g = r // (m / n_kv_heads)``, whole: that head's
columns of ``wk`` and ``wv``.  Each kv head is held alike by the ``m /
n_kv_heads`` ranks of its group, and since each rank's ``dk``/``dv``
hold only its own query heads' part, the group sums those weights'
gradients (:func:`kv_group_sum`, over the mesh's kv group, census keys
``"kv/..."``).  GSPMD cuts ``wk``'s columns contiguously instead,
wherever ``shard_if_divisible`` allows, which splits a kv head across
ranks; as with the Mamba blocks below, the two cuts compute the same
function, and only the cut on whole heads lets each rank run its own
heads' attention.

A Mamba-2 block's packed leaves are cut on whole SSD heads, segment by
segment (:func:`packed_segments`): ``w_in``'s columns ``[z | x | B | C
| dt]`` give a rank ``[z_r | x_r | B | C | dt_r]`` and ``conv_w``'s
channels ``[x | B | C]`` give it ``[x_r | B | C]``, with ``B`` and ``C``
whole on every rank when the block has one group (split with their
heads when the groups divide ``m``).  GSPMD cuts these leaves into
contiguous blocks instead, wherever ``shard_if_divisible`` allows: the
two cuts compute the same function, and only the cut on heads lets each
rank run its own heads' scan.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

UNITS = ("attn", "ffn", "shared_ffn", "moe", "vocab", "lin", "mamba")

# leaf path -> the unit it belongs to; leaves of no unit (norms, the
# router, biases) are replicated on every rank
_UNIT_RULES = (
    (r"attn/(wq|wk|wv|wo)$", "attn"),
    (r"shared_ffn/(w_gate|w_up|w_down)$", "shared_ffn"),
    (r"(^|/)ffn/(w_gate|w_up|w_down|w_in|b_in|w_out)$", "ffn"),
    (r"moe/(w_gate|w_up|w_down)$", "moe"),
    (r"(^|/)(embed/table|lm_head/w)$", "vocab"),
    (r"(^|/)lin/w$", "lin"),
    (r"mamba/(w_in|conv_w|a_log|dt_bias|D|gate_norm/scale|w_out)$",
     "mamba"),
)

def unit_of(path: str) -> Optional[str]:
    """The unit a leaf path belongs to, or None."""
    for pat, unit in _UNIT_RULES:
        if re.search(pat, path):
            return unit
    return None


def kv_replicas(cfg, m: int) -> int:
    """How many ranks of a ``model`` axis of ``m`` hold each kv head alike:
    ``m / n_kv_heads`` where the attention unit splits over kv head
    groups (``n_heads % m == 0``, ``n_kv_heads < m`` and ``m %
    n_kv_heads == 0``), else 1 (the heads split evenly, or the unit
    stays whole)."""
    if cfg is None or m == 1:
        return 1
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % m == 0 and kv < m and m % kv == 0:
        return m // kv
    return 1


def sharded_units(cfg, sizes) -> dict:
    """The whole-unit rule: {unit: whether it splits over the ``model``
    axis of a mesh of ``sizes`` (axis name -> size)}.  Reads the
    config's shapes only.  ``cfg`` None is a stage model
    (``models.cnn``), which has no config: its ``lin`` unit may split,
    and each ``lin/w`` does where its columns divide the axis
    (:meth:`TensorParallel.splits`).  A Mamba-2 block splits on whole
    SSD heads, its ``B``/``C`` groups whole on every rank (one group) or
    split with their heads.  An attention unit splits on whole query
    heads where its kv heads split evenly or fall into groups of ranks
    (:func:`kv_replicas`)."""
    m = sizes.get("model", 1)
    out = dict.fromkeys(UNITS, False)
    if m == 1:
        return out
    if cfg is None:
        out["lin"] = True
        return out
    out["vocab"] = cfg.vocab_padded % m == 0
    if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        out["mamba"] = heads % m == 0 and (s.n_groups == 1
                                           or s.n_groups % m == 0)
        if cfg.family == "ssm":          # attention-free
            return out
    out["attn"] = cfg.n_heads % m == 0 and (cfg.n_kv_heads % m == 0
                                            or m % cfg.n_kv_heads == 0)
    if cfg.moe is None:
        out["ffn"] = cfg.d_ff % m == 0
    else:
        moe = cfg.moe
        out["moe"] = (moe.n_experts if moe.shard_mode == "expert"
                      else moe.d_ff_expert) % m == 0
        if moe.n_shared_experts:
            out["shared_ffn"] = (moe.n_shared_experts
                                 * moe.d_ff_expert) % m == 0
    return out


def packed_segments(cfg, path: str) -> Optional[tuple]:
    """The packed layout of a Mamba-2 leaf along the dimension its spec
    puts on ``model``: ``((width, split), ...)`` in order, each segment
    cut over the axis (``split``) or whole on every rank; None for any
    other leaf (cut contiguously, if at all).  ``w_in``'s columns are
    ``[z | x | B | C | dt]`` (``models/mamba2.py``), ``conv_w``'s
    channels ``[x | B | C]``; ``B`` and ``C`` split only with more than
    one group."""
    if cfg is None or cfg.ssm is None:
        return None
    is_w_in = re.search(r"mamba/w_in$", path) is not None
    if not is_w_in and re.search(r"mamba/conv_w$", path) is None:
        return None
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    gn, groups = s.n_groups * s.d_state, s.n_groups > 1
    segs = ((d_inner, True), (gn, groups), (gn, groups))
    if is_w_in:
        return ((d_inner, True),) + segs + ((d_inner // s.head_dim, True),)
    return segs


def rank_segments(segs, m: int, r: int) -> tuple:
    """Rank ``r``'s part of a packed dimension of layout ``segs`` (see
    :func:`packed_segments`) on a model axis of ``m``: ``((lo, hi,
    split), ...)``, ranges of the whole dimension, concatenated in
    order."""
    out, off = [], 0
    for width, split in segs:
        if split:
            per = width // m
            out.append((off + r * per, off + (r + 1) * per, True))
        else:
            out.append((off, off + width, False))
        off += width
    return tuple(out)


def take_segments(x, ranges, dim: int = -1):
    """The ranges ``((lo, hi, split), ...)`` of ``x`` along ``dim``,
    concatenated in order (a rank's packed part; see
    :func:`rank_segments`)."""
    return torch.cat([x.narrow(dim, lo, hi - lo) for lo, hi, _ in ranges],
                     dim=dim)


class TensorParallel:
    """What the model code needs of the ``model`` axis: its collectives
    (``comm``, None off the mesh), this rank's place on it and which
    units split (:func:`sharded_units`).  Where the attention splits
    over kv head groups, ``kv_rep`` ranks hold each kv head
    (:func:`kv_replicas`), ``kv_comm`` is the collectives of this
    rank's group and ``kv_group`` the kv head it holds."""

    def __init__(self, comm, units: dict, kv_comm=None, kv_rep: int = 1):
        self.comm = comm
        self.units = dict(units)
        self.size = 1 if comm is None else comm.size
        self.rank = 0 if comm is None else comm.rank
        self.kv_comm, self.kv_rep = kv_comm, kv_rep
        self.kv_group = self.rank // kv_rep

    @classmethod
    def from_mesh(cls, mesh, cfg=None) -> "TensorParallel":
        """The mesh's model axis for a transformer of ``cfg``, or for a
        stage model (``cfg`` None), with the kv group's collectives the
        mesh built (``Mesh.kv_comms``) where the attention splits over
        kv head groups."""
        units = sharded_units(cfg, mesh.shape)
        rep = kv_replicas(cfg, mesh.shape.get("model", 1)) \
            if units["attn"] else 1
        return cls(mesh.model_comm, units,
                   mesh.kv_comms[rep] if rep > 1 else None, rep)

    def on(self, unit: str) -> bool:
        """Whether ``unit`` runs split over more than one rank."""
        return self.size > 1 and self.units[unit]

    def heads(self, cfg) -> tuple[int, int]:
        """This rank's (query heads, kv heads) of an attention block of
        ``cfg``: all of them where the unit runs whole, else its
        ``n_heads / m`` and its ``n_kv_heads / m``, or with fewer kv heads
        than ranks the one kv head of its group (:func:`kv_replicas`)."""
        if not self.on("attn"):
            return cfg.n_heads, cfg.n_kv_heads
        return cfg.n_heads // self.size, max(cfg.n_kv_heads // self.size, 1)

    def splits(self, n_out: int) -> bool:
        """Whether a stage model's ``lin/w`` of ``n_out`` columns is split
        (column-parallel): where the columns divide the axis, as
        ``shard_if_divisible`` reads the ``lin/w`` spec."""
        return self.on("lin") and n_out % self.size == 0


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


class _KVGroupSum(_CopyToModel):
    """:class:`_CopyToModel` over a kv head group: identity forward, the
    gradients' float32 sum over the group's ranks backward."""


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


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, dims, sum_over, *xs):
        ctx.comm, ctx.dims, ctx.sum_over = comm, dims, sum_over
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        # a leaf at a time: the gathered copy is the only whole one held
        return tuple(comm.all_gather(x.movedim(d, 0), "weights")
                     .movedim(0, d).contiguous() for x, d in zip(xs, dims))

    @staticmethod
    def backward(ctx, *gs):
        comm, dims = ctx.comm, ctx.dims
        out = []
        for g, d, (s, dt, dev) in zip(gs, dims, ctx.meta):
            if g is None:
                out.append(torch.zeros(s, dtype=dt, device=dev))
            elif ctx.sum_over is not None:
                (blk,) = reduce_to_blocks(comm, ctx.sum_over, [g.float()],
                                          [d], "wgrads")
                out.append(blk.to(dt).contiguous())
            else:
                out.append(g.narrow(d, comm.rank * s[d], s[d]).contiguous())
        return (None, None, None) + tuple(out)


def reduce_to_blocks(comm, sum_over, tensors: list, dims, what: str
                     ) -> list:
    """Each rank's block (along ``dims``, over the ``data`` axis' ``comm``)
    of the sum over the ranks of ``sum_over`` of whole ``tensors``: one
    ``reduce_scatter`` per dtype when the partial sums lie on the data
    axis' ranks alone (``sum_over`` is ``comm``), else (a ``pod`` axis
    beside it) one ``all_reduce`` over ``sum_over`` and the rank's
    block."""
    if sum_over is comm:
        parts = comm.reduce_scatter_tree(
            [t.movedim(d, 0) for t, d in zip(tensors, dims)], what)
        return [p.movedim(0, d) for p, d in zip(parts, dims)]
    sums = sum_over.all_reduce_tree(list(tensors), what)
    return [t.narrow(d, comm.rank * (t.shape[d] // comm.size),
                     t.shape[d] // comm.size)
            for t, d in zip(sums, dims)]


def gather_from_data(comm, tree, plan, sum_over=None):
    """FSDP's gather at use: ``tree`` (a params tree whose leaves split
    over ``data`` hold this rank's block, as ``plan`` says) with those
    leaves all-gathered over ``comm`` (the mesh's ``data_comm``), one
    call a leaf (census ``all_gather/weights``; a leaf at a time, so no
    buffer of the whole tree is held beside the gathered leaves).  The
    backward gives each rank its block of the whole gradient: with
    ``sum_over`` (the collectives of the ranks whose minibatches differ,
    each gradient a partial sum) the blocks of the sum over them, in
    float32, a call a leaf (:func:`reduce_to_blocks`, census
    ``reduce_scatter/wgrads``), rounded to the leaf's dtype after the
    sum; without (the same minibatch on every rank, the whole gradient
    on each) the rank's own block, with no collective.  ``comm`` None,
    or no leaf split: ``tree`` as it is."""
    if comm is None:
        return tree
    leaves, shards = tree_leaves(tree), tree_leaves(plan)
    idx = [i for i, s in enumerate(shards) if s.ddim is not None]
    if not idx:
        return tree
    got = _GatherFromData.apply(comm, tuple(shards[i].ddim for i in idx),
                                sum_over, *(leaves[i] for i in idx))
    leaves = list(leaves)
    for i, g in zip(idx, got):
        leaves[i] = g
    return tree_unflatten_like(tree, leaves)


def copy_to_model(tp: Optional[TensorParallel], *xs,
                  what: str = "act_grad"):
    """Each of ``xs`` as it is, whose gradients, partial on each rank
    (each holds its shard's part), are summed over the ``model`` axis in
    one float32 all-reduce.  Returns one tensor for one input, else a
    tuple."""
    if _on(tp):
        xs = _CopyToModel.apply(tp.comm, what, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def kv_group_sum(tp: Optional[TensorParallel], *ws):
    """Each of ``ws`` (a rank's ``wk``, ``wv``: its group's whole kv head)
    as it is, whose gradients, each rank's part from its own query heads,
    are summed over the kv group in one float32 all-reduce (census
    ``kv/all_reduce/kv_grad``), so every rank of the group steps its copy
    alike.  Where each rank holds its own kv heads (``kv_rep`` 1) the
    weights pass as they are.  Returns one tensor for one input, else a
    tuple."""
    if tp is not None and tp.kv_rep > 1:
        if tp.kv_comm is None:
            raise RuntimeError(f"kv heads held by groups of {tp.kv_rep} "
                               "ranks need the mesh's kv group "
                               "(Mesh.kv_comms)")
        ws = _KVGroupSum.apply(tp.kv_comm, "kv_grad", *ws)
    return ws[0] if len(ws) == 1 else tuple(ws)


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


def global_norm(grads, tp: Optional[TensorParallel] = None, plan=None,
                data=None):
    """The global L2 norm of a gradient tree whose split leaves hold this
    rank's block: each block's squares count once.  ``plan`` (a
    ``sharding.specs`` plan of the tree) says which leaves split over
    the model axis (``tp``) and over ``data`` (where ``data``, the data
    axis' collectives, is given).  The squares of the model-split leaves
    are summed over the model axis in one all-reduce (with those split
    over both axes beside them), those of the data-split leaves over
    ``data`` in one more; the replicated leaves' are counted once, and
    so are the segments of a packed leaf that every rank holds whole
    (a Mamba block's ``B``/``C`` columns), and a kv head held alike by
    the ranks of its group (``Shard.rep``) by the group's first rank
    alone.  Without a plan every leaf is whole: the unsharded
    arithmetic."""
    leaves = tree_leaves(grads)
    shards = tree_leaves(plan) if plan is not None else [None] * len(leaves)
    sq = lambda g: torch.sum(torch.square(g.float()))
    parts = {(m, d): [] for m in (False, True) for d in (False, True)}
    for g, s in zip(leaves, shards):
        fd = s is not None and data is not None and s.ddim is not None
        if s is None or not _on(tp) or s.dim is None:
            parts[(False, fd)].append(sq(g))
        elif s.segs is None:
            part = sq(g)
            if tp.rank % s.rep:        # the group's first rank counts it
                part = torch.zeros_like(part)
            parts[(True, fd)].append(part)
        else:
            widths = [hi - lo for lo, hi, _ in s.segs]
            for piece, (_, _, split) in zip(torch.split(g, widths, s.dim),
                                            s.segs):
                parts[(split, fd)].append(sq(piece))
    norm2 = sum(parts[(False, False)])
    m_only, d_only, both = (parts[(True, False)], parts[(False, True)],
                            parts[(True, True)])
    if both:
        zero = torch.zeros((), dtype=torch.float32, device=both[0].device)
        red = tp.comm.all_reduce(torch.stack([sum(m_only, zero),
                                              sum(both)]), "grad_norm")
        norm2 = norm2 + red[0]
        d_only = d_only + [red[1]]
    elif m_only:
        norm2 = norm2 + tp.comm.all_reduce(sum(m_only), "grad_norm")
    if d_only:
        norm2 = norm2 + data.all_reduce(sum(d_only), "grad_norm")
    return torch.sqrt(norm2)
