"""Running the LM on ``torch.distributed.tensor`` shards (DTensor), the
counterpart of what the reference leaves to XLA's SPMD partitioner.

DTensor propagates placements op by op, so the model's code runs on
sharded parameters and batches unchanged, in global shapes.  Four
places need help, and each helper here is the plain code when its
tensor is not a DTensor:

* ``embed_lookup`` -- the token embedding.  A vocabulary sharded over
  ``model`` is looked up on each shard with the tokens outside it
  masked (Megatron's vocab-parallel embedding): the output is a partial
  sum over ``model``, the table's gradient stays on its shard, and over
  the data axes it is a partial sum, reduced where the step reduces the
  other gradients.
* ``ce_terms`` -- the cross entropy's log-sum-exp and label logit over
  vocab-sharded logits: a max, a sum of exponentials and a masked
  gather per shard, each reduced over ``model`` (vocab-parallel cross
  entropy), instead of gathering the logits.
* ``constrain`` -- redistribute an activation, and its gradient, to
  given placements (the reference's ``with_sharding_constraint``).
* ``local_attention`` -- attention (the flash kernels, which take plain
  tensors, or the plain path) on each device's batch rows and heads
  through ``local_map``: attention couples no rows and no heads, so it
  needs no collective, and DTensor does not have to plan the reshapes
  of its sharded head axis.

On a mesh dimension of size 1 a shard is the whole tensor, so each
helper runs the plain code on it: a one-device mesh gives the plain
step's numbers bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _as_dtensor(x: torch.Tensor, mesh):
    """``x`` itself, or a plain tensor as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _Pin(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward, and the gradient
    to the same placements in the backward (Megatron's all-reduce of a
    column-parallel input's gradient, which DTensor would otherwise
    leave partial and reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def constrain(x, placements: Optional[Sequence]):
    """``x`` redistributed to ``placements``, its gradient too (None,
    or a plain tensor: ``x`` unchanged)."""
    if placements is None or not is_dtensor(x):
        return x
    return _Pin.apply(x, list(placements))


def hold(x):
    """``x`` with its gradient put on ``x``'s own placements (a plain
    tensor: ``x``): the gradient of heads merged after an uneven head
    split must not arrive sharded where the split cannot take it."""
    return constrain(x, x.placements) if is_dtensor(x) else x


def even(t: torch.Tensor, dim: int, count: int) -> torch.Tensor:
    """``t`` with its sharding of tensor dimension ``dim`` gathered over
    every mesh dimension whose size does not divide ``count`` (the number
    of heads, or kv groups, that dimension is about to be split into; a
    plain tensor: ``t``).  DTensor cannot split a dimension it holds
    unevenly."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    dim = dim % t.ndim
    want = [Replicate() if p.is_shard(dim) and count % mesh.size(d) else p
            for d, p in enumerate(t.placements)]
    if want != list(t.placements):
        t = t.redistribute(mesh, want)
    return t


def split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """``t`` (B, S, heads * hd) as (B, S, heads, hd), on a DTensor after
    ``even`` (8 kv heads over 16 model ways are gathered first)."""
    B, S = t.shape[:2]
    return even(t, -1, heads).reshape(B, S, heads, hd)


def _vocab_dim(mesh, placements, dim: int) -> Optional[int]:
    """The one mesh dimension of size > 1 that shards tensor dimension
    ``dim`` (None when none does)."""
    dims = [d for d, p in enumerate(placements)
            if p.is_shard(dim) and mesh.size(d) > 1]
    if len(dims) > 1:
        raise NotImplementedError(
            f"a vocabulary sharded over {len(dims)} mesh dimensions")
    return dims[0] if dims else None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a DTensor table, per shard (module
    docstring)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    vdim = _vocab_dim(mesh, table.placements, 0)
    out_pl, grad_pl = [], []
    for d, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        if kp.is_shard() and mesh.size(d) > 1:
            if d == vdim:
                raise NotImplementedError(
                    "tokens and vocabulary sharded over one mesh dimension")
            out_pl.append(Shard(kp.dim))
            grad_pl.append(Partial())
        elif d == vdim:
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        else:
            out_pl.append(Replicate())
            grad_pl.append(tp)

    def lookup(t, idx):
        if vdim is None:
            return t[idx]
        lo = mesh.get_local_rank(vdim) * t.shape[0]
        outside = (idx < lo) | (idx >= lo + t.shape[0])
        rows = t[(idx - lo).masked_fill(outside, 0)]
        return rows.masked_fill(outside[..., None], 0)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(table.placements, tokens.placements),
                     in_grad_placements=(grad_pl, tokens.placements),
                     device_mesh=mesh)(table, tokens)


def ce_terms(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the vocabulary, the label's logit), each (B, S);
    on DTensor logits, per vocabulary shard (module docstring)."""
    if not is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None])[..., 0])
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    V = logits.ndim - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(
            mesh, [Replicate() if p.is_partial() else p
                   for p in logits.placements])
    vdim = _vocab_dim(mesh, logits.placements, V)
    # the (B, S) results: the logits' placements without the vocabulary
    rows = [Replicate() if p.is_shard(V) else p for p in logits.placements]
    labels = constrain(_as_dtensor(labels, mesh), rows)
    if vdim is None:
        def plain(lg, lab):
            return (torch.logsumexp(lg, dim=-1),
                    lg.gather(-1, lab[..., None])[..., 0])
        return local_map(plain, out_placements=(rows, rows),
                         in_placements=(logits.placements, rows),
                         device_mesh=mesh)(logits, labels)

    def partial_at(op: str) -> list:
        return [Partial(op) if d == vdim else p for d, p in enumerate(rows)]

    def shard_max(lg):
        return lg.detach().amax(dim=-1)

    m = local_map(shard_max, out_placements=partial_at("max"),
                  in_placements=(logits.placements,),
                  device_mesh=mesh)(logits)
    m = m.redistribute(mesh, rows)

    def shard_terms(lg, mx, lab):
        n = lg.shape[-1]
        lo = mesh.get_local_rank(vdim) * n
        outside = (lab < lo) | (lab >= lo + n)
        idx = (lab - lo).masked_fill(outside, 0)
        picked = lg.gather(-1, idx[..., None])[..., 0]
        return (torch.exp(lg - mx[..., None]).sum(dim=-1),
                picked.masked_fill(outside, 0))

    s, picked = local_map(shard_terms,
                          out_placements=(partial_at("sum"),
                                          partial_at("sum")),
                          in_placements=(logits.placements, rows, rows),
                          device_mesh=mesh)(logits, m, labels)
    s = s.redistribute(mesh, rows)
    picked = picked.redistribute(mesh, rows)
    return m + torch.log(s), picked


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous:
    ``local_map`` hands a local gradient to DTensor with the strides of
    the local input, and a permuted one breaks DTensor's later views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_attention(fn: Callable, q, k, v, positions, kv_len, **kwargs):
    """``fn(q, k, v, positions, kv_len, **kwargs) -> out`` (B, S, H, hd):
    attention, run on each device's batch rows and heads when ``q`` is a
    DTensor.  Per mesh dimension: a batch sharding of ``q`` shards k, v,
    ``positions`` (B, S) and ``kv_len`` (B,) alike; a head sharding of
    ``q`` is kept where k and v share it, or where they are replicated
    and each device's query heads read a whole number of kv groups (the
    device then slices its kv heads out of them); any other sharding is
    gathered first.  Plain tensors: ``fn`` as it is."""
    if not is_dtensor(q):
        return fn(q, k, v, positions, kv_len, **kwargs)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    H, Hkv = q.shape[2], k.shape[2]
    qp, kp, rp, kgrad = [], [], [], []
    sliced = None
    for d in range(mesh.ndim):
        n = mesh.size(d)
        pq, pk = q.placements[d], k.placements[d]
        if n == 1 or pq.is_shard(0):
            same = pq if n > 1 else Replicate()
            qp.append(same)
            kp.append(same)
            kgrad.append(same)
            rp.append(Shard(0) if n > 1 else Replicate())
            continue
        rp.append(Replicate())
        if pq.is_shard(2) and H % n == 0 and pk.is_shard(2) \
                and v.placements[d].is_shard(2) and Hkv % n == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
            kgrad.append(Shard(2))
        elif pq.is_shard(2) and H % n == 0 and sliced is None and (
                (H // n) % (H // Hkv) == 0 or (H // Hkv) % (H // n) == 0):
            sliced = d
            qp.append(Shard(2))
            kp.append(Replicate())
            kgrad.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    positions = constrain(_as_dtensor(positions, mesh), rp)
    args = [q, k, v, positions]
    in_pl = [qp, kp, kp, rp]
    grads = [qp, kgrad, kgrad, rp]
    if kv_len is not None:
        args.append(constrain(_as_dtensor(kv_len, mesh), rp))
        in_pl.append(rp)
        grads.append(rp)
    group = H // Hkv

    def attend(ql, kl, vl, pos, *lens):
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        if sliced is not None:
            h0 = mesh.get_local_rank(sliced) * ql.shape[2]
            lo, hi = h0 // group, (h0 + ql.shape[2] - 1) // group + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, pos, lens[0] if lens else None, **kwargs)

    return local_map(attend, out_placements=qp, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


def local_ssd(fn: Callable, x, dt, A, B, C, seq_lens=None):
    """``fn(x, dt, A, B, C, seq_lens) -> y`` (B, S, H, P): the SSD chunk
    scan, run on each device's batch rows and heads when ``x`` is a
    DTensor (the scan couples neither; its chunk loop then runs on plain
    local tensors).  Per mesh dimension: a batch sharding of ``x``
    shards dt, B, C and ``seq_lens`` alike; a head sharding that divides
    the heads shards dt and A with it (B and C, shared by every head,
    stay whole); any other sharding is gathered first.  Plain tensors:
    ``fn`` as it is."""
    if not is_dtensor(x):
        return fn(x, dt, A, B, C, seq_lens)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    H = x.shape[2]
    xp, dp, ap, bp, rp = [], [], [], [], []
    a_grad, b_grad = [], []
    for d in range(mesh.ndim):
        n, px = mesh.size(d), x.placements[d]
        if n > 1 and px.is_shard(0):
            xp.append(Shard(0)), dp.append(Shard(0)), bp.append(Shard(0))
            ap.append(Replicate()), rp.append(Shard(0))
            a_grad.append(Partial()), b_grad.append(Shard(0))
        elif n > 1 and px.is_shard(2) and H % n == 0:
            xp.append(Shard(2)), dp.append(Shard(2)), bp.append(Replicate())
            ap.append(Shard(0)), rp.append(Replicate())
            a_grad.append(Shard(0)), b_grad.append(Partial())
        else:
            for lst in (xp, dp, ap, bp, rp, a_grad, b_grad):
                lst.append(Replicate())
    args = [x.redistribute(mesh, xp),
            _as_dtensor(dt, mesh).redistribute(mesh, dp),
            _as_dtensor(A, mesh).redistribute(mesh, ap),
            _as_dtensor(B, mesh).redistribute(mesh, bp),
            _as_dtensor(C, mesh).redistribute(mesh, bp)]
    in_pl = [xp, dp, ap, bp, bp]
    grads = [xp, dp, a_grad, b_grad, b_grad]
    if seq_lens is not None:
        args.append(constrain(_as_dtensor(seq_lens, mesh), rp))
        in_pl.append(rp)
        grads.append(rp)

    def scan(xl, dtl, al, bl, cl, *lens):
        xl, dtl, bl, cl = (_ContiguousGrad.apply(t)
                           for t in (xl, dtl, bl, cl))
        return fn(xl, dtl, al, bl, cl,
                  lens[0] if lens else None).contiguous()

    return local_map(scan, out_placements=xp, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


def local_shard(t: torch.Tensor, mesh, placements):
    """``t`` (the global tensor, the same on every rank) as a DTensor at
    ``placements`` that keeps a copy of this rank's chunk of it (a view
    would keep all of ``t`` alive): no collective, so a fake process
    group places real values, and ``meta`` stays ``meta``.  Chunks
    follow ``Shard``'s split (``torch.chunk``, mesh dimensions in
    order)."""
    from torch.distributed.tensor import DTensor
    local = t
    for d, p in enumerate(placements):
        if p.is_shard():
            parts = torch.chunk(local, mesh.size(d), dim=p.dim)
            r = mesh.get_local_rank(d)
            local = (parts[r] if r < len(parts)
                     else local.narrow(p.dim, 0, 0))
    return DTensor.from_local(
        local.clone(memory_format=torch.contiguous_format), mesh,
        list(placements), run_check=False, shape=t.shape, stride=t.stride())


def distribute_parameters(module: nn.Module, shardings: Mapping[str, tuple],
                          mesh) -> Dict[str, torch.Tensor]:
    """Replace every parameter of ``module`` by a DTensor parameter on
    ``mesh`` at its placements (``shardings``: ``{name: (spec,
    placements)}``, as ``sharding/specs.params_shardings`` gives them),
    keeping this rank's chunk (``local_shard``); returns ``{name: new
    parameter}``."""
    out = {}
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        new = nn.Parameter(local_shard(p.detach(), mesh, shardings[name][1]),
                           requires_grad=p.requires_grad)
        setattr(mod, leaf, new)
        out[name] = new
    return out
