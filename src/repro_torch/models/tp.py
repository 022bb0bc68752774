"""The blocks over DTensors: tensor parallelism over "model", FSDP and data
parallelism over the other mesh dims, each mixer and ffn run on its local
shards.

DTensor's own sharding rules cover the model's glue (norms, residual
adds), but not the inside of a mixer: folding sharded heads into kv
groups, flattening (heads, head_dim) into a product, the MoE dispatch and
the recurrences split a sharded dim unevenly or have no rule at all. So
each component runs on local shards (`local_map`) in a layout chosen
here, Megatron's:

  * the activation: batch sharded over the data-parallel dims (pod, data)
    where they divide it, replicated over "model";
  * the weights: gathered over the data-parallel dims (FSDP), and over
    "model" split where the component is tensor parallel: attention by
    whole heads (kv groups sliced to the local heads when the groups do
    not divide), the MLP by its hidden dim, MoE by experts (or by the
    expert hidden dim when the experts do not divide), rwkv6 by heads,
    mamba by d_inner (in two calls: x_proj sums over d_inner, so its
    output is all-reduced before the scan);
  * the output: summed over "model" where split (all-reduce), replicated
    otherwise;
  * gradients: a replicated input of a split component gets a pending
    sum; a weight gathered over the batch-sharded dims too (FSDP's
    reduce-scatter).

The embedding, the unembedding and the loss are vocab parallel. Decode
runs each mixer on its state redistributed to that layout; attention's
kv cache is gathered over "model" (cache_spec shards it on head_dim,
which a head-split attention cannot use). decode_step writes each new
state back in its cache's own placements.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import layers


def _model_dim(mesh) -> int | None:
    names = list(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def _model_size(mesh) -> int:
    md = _model_dim(mesh)
    return 1 if md is None else mesh.size(md)


def _model_rank(mesh) -> int:
    md = _model_dim(mesh)
    return 0 if md is None else mesh.get_local_rank(md)


def _batch_layout(mesh, b: int) -> list:
    """Placements of an activation of batch b (dim 0): sharded over each
    data-parallel mesh dim (every dim but "model") while the sizes divide
    it, else replicated."""
    pl, left = [], b
    for i, name in enumerate(mesh.mesh_dim_names):
        if name != "model" and left % mesh.size(i) == 0:
            pl.append(Shard(0))
            left //= mesh.size(i)
        else:
            pl.append(Replicate())
    return pl


def _with_model(pl: list, mesh, placement) -> list:
    md = _model_dim(mesh)
    out = list(pl)
    if md is not None:
        out[md] = placement
    return out


class _Call:
    """The inputs of one `local_map` call, each with its placements and its
    gradient's. `split`: the component is split over "model", so its
    replicated inputs' gradients are pending sums there."""

    def __init__(self, mesh, batch: int, split: bool):
        self.mesh, self.split = mesh, split
        self.act = _batch_layout(mesh, batch)
        self.inputs: list = []

    def _add(self, t, pl, grad) -> int:
        if not isinstance(t, DTensor):  # a constant the model made: replicated
            t = DTensor.from_local(t, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        self.inputs.append((t, tuple(pl), tuple(grad)))
        return len(self.inputs) - 1

    def activation(self, t) -> int:
        """Batch first, in the call's layout, replicated over "model"."""
        pl = _batch_layout(self.mesh, t.shape[0])
        return self._add(t, pl, _with_model(pl, self.mesh,
                                            Partial() if self.split else Replicate()))

    def sharded(self, t, dim: int) -> int:
        """Batch first, split on tensor dim `dim` over "model"."""
        pl = _with_model(_batch_layout(self.mesh, t.shape[0]), self.mesh, Shard(dim))
        return self._add(t, pl, pl)

    def weight(self, t, model_dim: int | None) -> int:
        """Gathered over the data-parallel dims, split on tensor dim
        `model_dim` over "model" (None: replicated)."""
        pl = [Replicate()] * self.mesh.ndim
        # summed over the ranks that split the batch
        grad = [Partial() if p.is_shard() else Replicate() for p in self.act]
        md = _model_dim(self.mesh)
        if md is not None:
            if model_dim is not None:
                pl[md] = grad[md] = Shard(model_dim)
            else:
                grad[md] = Partial() if self.split else Replicate()
        return self._add(t, pl, grad)

    def params(self, p, split_dims: dict, prefix: str = "") -> dict:
        """p's leaves as inputs, split as `split_dims` ({dotted name: tensor
        dim}) says: {name: input index, or a nested dict}."""
        out = {}
        for k in p.keys():
            v, name = p[k], f"{prefix}{k}"
            if isinstance(v, (torch.nn.Module, dict)):
                out[k] = self.params(v, split_dims, name + ".")
            else:
                out[k] = self.weight(v, split_dims.get(name))
        return out

    def out(self) -> list:
        """The output's placements: summed over "model" where split."""
        return _with_model(self.act, self.mesh, Partial() if self.split else Replicate())

    def out_sharded(self, dim: int) -> list:
        return _with_model(self.act, self.mesh, Shard(dim))

    def run(self, fn, out_placements):
        """fn(locals) on the inputs' local shards; a list of placements for
        one output, a tuple of them for several. Pending sums are taken."""
        ts, pls, grads = zip(*self.inputs)
        out = local_map(lambda *local: fn(list(local)), out_placements, in_placements=pls,
                        in_grad_placements=grads, device_mesh=self.mesh,
                        redistribute_inputs=True)(*ts)
        return tuple(map(_settled, out)) if isinstance(out, tuple) else _settled(out)


def _settled(x: DTensor) -> DTensor:
    """x with its pending sums taken (all-reduce), as Megatron reduces a
    row-parallel output: left pending, sharding propagation may reduce-
    scatter it instead, whose backward not every torch release has."""
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def _local(tree: dict, local: list) -> dict:
    return {k: _local(v, local) if isinstance(v, dict) else local[v] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _heads_split(cfg, n: int) -> tuple[bool, bool]:
    """(split heads over a model dim of n, and kv groups with them)."""
    h, g = cfg.num_heads, cfg.num_kv_heads
    if n == 1 or h % n:
        return False, False
    hl, m = h // n, h // g
    if g % n == 0:
        return True, True
    return (hl % m == 0 or m % hl == 0), False


def _attn_local(cfg, n: int, rank: int, kv_split: bool):
    """Local config, and the kv group slice of the local heads."""
    hl = cfg.num_heads // n
    if kv_split:
        return dataclasses.replace(cfg, num_heads=hl, num_kv_heads=cfg.num_kv_heads // n), None
    m = cfg.num_heads // cfg.num_kv_heads
    g0, g1 = rank * hl // m, ((rank + 1) * hl - 1) // m + 1
    return dataclasses.replace(cfg, num_heads=hl, num_kv_heads=g1 - g0), (g0, g1)


_ATTN_SPLIT = {"wq": 1, "bq": 0, "wo": 0}
_KV_SPLIT = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}


def _slice_kv(p: dict, groups):
    if groups is None:
        return p
    g0, g1 = groups
    p = dict(p)
    for k, d in _KV_SPLIT.items():
        if k in p:
            p[k] = p[k].narrow(d, g0, g1 - g0)
    return p


def attn_apply(fn, p, cfg, x, positions, q_chunk):
    mesh = x.device_mesh
    n = _model_size(mesh)
    split, kv_split = _heads_split(cfg, n)
    call = _Call(mesh, x.shape[0], split)
    tree = call.params(p, {**_ATTN_SPLIT, **(_KV_SPLIT if kv_split else {})} if split else {})
    ix, ipos = call.activation(x), call.activation(positions)
    lcfg, groups = _attn_local(cfg, n, _model_rank(mesh), kv_split) if split else (cfg, None)

    def run(local):
        return fn(_slice_kv(_local(tree, local), groups), lcfg, local[ix], local[ipos], q_chunk)

    return call.run(run, call.out())


def attn_decode(fn, p, cfg, x, cache_k, cache_v, cur_len):
    """Replicated over "model", on the kv cache gathered there."""
    mesh = x.device_mesh
    call = _Call(mesh, x.shape[0], False)
    tree = call.params(p, {})
    ix = call.activation(x)
    pl = call.out()
    ik, iv = call._add(cache_k, pl, pl), call._add(cache_v, pl, pl)
    out, ck, cv = call.run(
        lambda local: fn(_local(tree, local), cfg, local[ix], local[ik], local[iv], cur_len),
        (pl, pl, pl))
    if list(cache_k.placements) != pl:  # the write went to a gathered copy
        cache_k.copy_(ck)
        cache_v.copy_(cv)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def mlp_apply(fn, p, x, act):
    mesh = x.device_mesh
    n = _model_size(mesh)
    split = n > 1 and p["wi"].shape[1] % n == 0
    call = _Call(mesh, x.shape[0], split)
    tree = call.params(p, {"wi": 1, "wg": 1, "wo": 0} if split else {})
    ix = call.activation(x)
    return call.run(lambda local: fn(_local(tree, local), local[ix], act), call.out())


def moe_apply(fn, p, cfg, x):
    """Expert parallel where the experts divide "model" (each rank runs its
    experts' slice of the dispatch buffer), else split on the expert
    hidden dim; a dense residual branch is split on its hidden dim with
    them (a layer whose dense branch does not divide is not split). The
    dispatch and expert buffers exist only on local shards: the combined
    output is what the "moe_y" constraint pins."""
    mesh = x.device_mesh
    n = _model_size(mesh)
    e, f = cfg.num_experts, p["wi"].shape[2]
    by_expert = n > 1 and e % n == 0
    split = (n > 1 and (by_expert or f % n == 0)
             and ("dense" not in p or p["dense"]["wi"].shape[1] % n == 0))
    call = _Call(mesh, x.shape[0], split)
    dims = {}
    if split:
        dims = {"wi": 0, "wg": 0, "wo": 0} if by_expert else {"wi": 2, "wg": 2, "wo": 1}
        dims.update({"dense.wi": 1, "dense.wg": 1, "dense.wo": 0})
    tree = call.params(p, dims)
    ix = call.activation(x)
    experts = (_model_rank(mesh) * (e // n), e // n) if split and by_expert else None
    y = call.run(lambda local: fn(_local(tree, local), cfg, local[ix], experts=experts),
                 call.out())
    return layers.constrain(y, "moe_y")


# ---------------------------------------------------------------------------
# mamba / rwkv6
# ---------------------------------------------------------------------------
# mamba splits on d_inner: in_proj's two halves (xi, z) are narrowed to the
# local channels from the whole weight, as attention slices kv groups; the
# conv, dt_proj, dt_bias, A_log and D split with them, x_proj and out_proj
# on their d_inner rows.
_MAMBA_IN = {"conv": 1, "conv_b": 0, "x_proj": 0}
_MAMBA_OUT = {"dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def _mamba_split(p, mesh) -> bool:
    n = _model_size(mesh)
    return n > 1 and p["D"].shape[0] % n == 0


def _in_proj_local(w, mesh):
    """The local channels of both halves of the gathered in_proj."""
    di = w.shape[1] // 2
    dl = di // _model_size(mesh)
    c0 = _model_rank(mesh) * dl
    return torch.cat([w.narrow(1, c0, dl), w.narrow(1, di + c0, dl)], dim=1)


def _mamba_in_call(fn_in, p, cfg, x, split, *states):
    """The in half: (xi, z) split on d_inner, then x_proj's output summed
    over "model" (and any state outputs, split on their d_inner dim)."""
    mesh = x.device_mesh
    call = _Call(mesh, x.shape[0], split)
    names = ("in_proj", *_MAMBA_IN)
    tree = call.params({k: p[k] for k in names}, _MAMBA_IN if split else {})
    ix = call.activation(x)
    ist = [call.sharded(s, 2) if split else call.activation(s) for s in states]

    def run(local):
        lp = _local(tree, local)
        if split:
            lp["in_proj"] = _in_proj_local(lp["in_proj"], mesh)
        return fn_in(lp, cfg, local[ix], *(local[i] for i in ist))

    chan = call.out_sharded(2) if split else call.out()
    outs = (chan, chan, call.out()) + (chan,) * len(states)
    return call.run(run, outs)


def mamba_apply(fn_in, fn_out, p, cfg, x):
    mesh = x.device_mesh
    split = _mamba_split(p, mesh)
    xi, z, dbc = _mamba_in_call(fn_in, p, cfg, x, split)
    call = _Call(mesh, x.shape[0], split)
    tree = call.params({k: p[k] for k in _MAMBA_OUT}, _MAMBA_OUT if split else {})
    ixi, iz = (call.sharded(xi, 2), call.sharded(z, 2)) if split else (
        call.activation(xi), call.activation(z))
    idbc = call.activation(dbc)
    return call.run(lambda local: fn_out(_local(tree, local), cfg, local[ixi], local[iz],
                                         local[idbc]), call.out())


def mamba_decode(fn_in, fn_out, p, cfg, x, conv_buf, h):
    """conv_buf (B, w-1, di) and h (B, di, N) split on di with the weights."""
    mesh = x.device_mesh
    split = _mamba_split(p, mesh)
    xi, z, dbc, window = _mamba_in_call(fn_in, p, cfg, x, split, conv_buf)
    call = _Call(mesh, x.shape[0], split)
    tree = call.params({k: p[k] for k in _MAMBA_OUT}, _MAMBA_OUT if split else {})
    if split:
        ixi, iz, ih = call.sharded(xi, 2), call.sharded(z, 2), call.sharded(h, 1)
    else:
        ixi, iz, ih = call.activation(xi), call.activation(z), call.activation(h)
    idbc = call.activation(dbc)
    out, h = call.run(lambda local: fn_out(_local(tree, local), cfg, local[ixi], local[iz],
                                           local[idbc], local[ih]),
                      (call.out(), call.out_sharded(1) if split else call.out()))
    return out, window[:, 1:], h


_RWKV_SPLIT = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wb": 1, "w0": 0, "u": 0, "wo": 0}


def _rwkv_local(cfg, mesh):
    """(split by heads, the local config)."""
    n = _model_size(mesh)
    if n == 1 or cfg.num_heads % n:
        return False, cfg
    return True, dataclasses.replace(cfg, d_model=cfg.d_model // n, num_heads=cfg.num_heads // n)


def rwkv6_apply(fn, p, cfg, x):
    mesh = x.device_mesh
    split, lcfg = _rwkv_local(cfg, mesh)
    call = _Call(mesh, x.shape[0], split)
    tree = call.params(p, _RWKV_SPLIT if split else {})
    ix = call.activation(x)
    return call.run(lambda local: fn(_local(tree, local), lcfg, local[ix]), call.out())


def rwkv6_decode(fn, p, cfg, x, x_prev, state):
    """state (B, H, hd, hd) split by heads with the weights."""
    mesh = x.device_mesh
    split, lcfg = _rwkv_local(cfg, mesh)
    call = _Call(mesh, x.shape[0], split)
    tree = call.params(p, _RWKV_SPLIT if split else {})
    ix, ip = call.activation(x), call.activation(x_prev)
    ist = call.sharded(state, 1) if split else call.activation(state)
    rep = _with_model(call.act, mesh, Replicate())
    return call.run(lambda local: fn(_local(tree, local), lcfg, local[ix], local[ip], local[ist]),
                    (call.out(), rep, call.out_sharded(1) if split else rep))


def rwkv6_ffn(fn, p, x, x_prev):
    mesh = x.device_mesh
    n = _model_size(mesh)
    split = n > 1 and p["wk"].shape[1] % n == 0
    call = _Call(mesh, x.shape[0], split)
    tree = call.params(p, {"wk": 1, "wv": 0} if split else {})
    ix, ip = call.activation(x), call.activation(x_prev)
    return call.run(lambda local: fn(_local(tree, local), local[ix], local[ip]), call.out())


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def xent_loss(logits, labels):
    """Mean token cross-entropy of vocab-sharded logits without gathering
    them (Megatron's vocab-parallel loss): the row max and the sum of
    exponentials reduce over "model" as (B, S) pending reductions, and the
    label's logit is picked on the shard that holds it. labels -100 are
    masked."""
    mesh = logits.device_mesh
    mask = labels >= 0
    labels_safe = torch.where(mask, labels, 0)
    x = logits.float()
    z = x - x.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(z).sum(-1))
    md = _model_dim(mesh)
    vocab_split = md is not None and z.placements[md] == Shard(z.ndim - 1)
    call = _Call(mesh, z.shape[0], vocab_split)
    iz = call.sharded(z, z.ndim - 1) if vocab_split else call.activation(z)
    il = call.activation(labels_safe)
    first = _model_rank(mesh) * z.shape[-1] // _model_size(mesh) if vocab_split else 0

    def pick(local):
        lz, lab = local[iz], local[il].long() - first
        mine = (lab >= 0) & (lab < lz.shape[-1])
        got = lz.gather(-1, torch.where(mine, lab, 0)[..., None])[..., 0]
        return torch.where(mine, got, 0.0)

    ll = call.run(pick, call.out()) - lse
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# the embedding and the unembedding
# ---------------------------------------------------------------------------
# Both run on local shards too, so that the two gradients of a tied table
# arrive in its stored placements and add without a conversion (a shard
# to a pending sum, which not every torch release has).


def _vocab_split(table, mesh) -> bool:
    n = _model_size(mesh)
    return n > 1 and table.shape[0] % n == 0


def embed(table, tokens):
    """Vocab-parallel lookup: each rank looks up the tokens its shard of
    the table holds, zeros elsewhere, and the shards' rows are summed."""
    mesh = table.device_mesh
    split = _vocab_split(table, mesh)
    call = _Call(mesh, tokens.shape[0], split)
    it = call.weight(table, 0 if split else None)
    ik = call.activation(tokens)
    first = _model_rank(mesh) * (table.shape[0] // _model_size(mesh)) if split else 0

    def run(local):
        lt, idx = local[it], local[ik].long() - first
        mine = (idx >= 0) & (idx < lt.shape[0])
        rows = torch.nn.functional.embedding(torch.where(mine, idx, 0), lt)
        return torch.where(mine[..., None], rows, 0)

    return call.run(run, call.out())


def unembed(x, table):
    """fp32 logits x @ table.T, sharded over vocab on "model" where the
    table's vocab divides it."""
    mesh = x.device_mesh
    split = _vocab_split(table, mesh)
    call = _Call(mesh, x.shape[0], split)
    ix = call.activation(x)
    it = call.weight(table, 0 if split else None)
    out = call.out_sharded(x.ndim - 1) if split else call.out()
    return call.run(lambda local: local[ix].float() @ local[it].float().T, out)
