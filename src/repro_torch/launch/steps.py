"""Step functions (port of ``make_train_step``, ``make_unified_step``,
``make_monolithic_prefill``, ``make_prefill_step``, ``set_cache_positions``,
``make_serve_step``, ``default_stem_cfg``, ``opt_state_shardings``,
``train_arg_shardings`` and ``abstract_opt_state`` from
``repro/launch/steps.py``).  PyTorch runs eagerly, so each step is a plain
closure; the reference's trace counting has no counterpart here, its
``shard_map`` + ``vmap`` over the serving mesh becomes a loop over the slot
groups (``make_unified_step(smesh=)``), its sharded train step a loop over
the data shards (``make_train_step(grad_shardings=)``), its prefill and
serve steps lowered under the dry run's shardings a loop over the data
shards too (``mesh_prefill_step``, ``mesh_serve_step``), and the page
extract / restore / copy steps are the engine's direct calls of
``runtime/offload.py`` and ``runtime/paged.py``."""
from __future__ import annotations

import contextlib
import types
from typing import Optional

import torch

from repro_torch import optim
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import StemConfig
from repro_torch.models import attention, mla, moe, transformer
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.arrays import ShardedArray


PAPER_STEM = StemConfig()   # paper defaults: B=128, mu=0.7, beta=0.2, floor 54


def default_stem_cfg(cfg) -> Optional[StemConfig]:
    """The prefill policy of the dry run's serving cells: the paper's
    defaults where the arch uses Stem."""
    return PAPER_STEM if cfg.use_stem else None


def loss_and_grads(bundle, master, batch: dict, *, stem_cfg=None, policies=None,
                   remat: bool = True):
    """(loss, metrics, gradient tree) of ``bundle.loss_fn`` at the fp32
    ``master``: the forward reads every leaf cast to the config's dtype
    (the fp32 embedding and router too, as the reference casts the whole
    tree) and the gradient is taken with respect to the fp32 master,
    through the cast.  A leaf the loss does not reach gets zeros, as under
    JAX's autodiff."""
    cfg = bundle.cfg
    kw = {"policies": policies} if policies else {}
    leaves = [m.detach().requires_grad_() for m in tree_leaves(master)]
    it = iter(leaves)
    params = tree_map(lambda _: next(it).to(cfg.torch_dtype), master)
    loss, metrics = bundle.loss_fn(params, batch, stem_cfg=stem_cfg, remat=remat, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    git = iter(torch.zeros_like(m) if g is None else g for m, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(git), master))


def make_train_step(bundle, opt_cfg: optim.AdamWConfig, *, stem_cfg=None,
                    policies=None, remat: bool = True, microbatches: int = 1,
                    grad_shardings=None):
    """(opt_state, batch) -> (opt_state, metrics).

    The gradient of each (micro)batch is ``loss_and_grads``'s.  With
    ``microbatches > 1`` the batch splits along its first axis, gradients
    accumulate in fp32 and are divided, and the metrics are the last
    microbatch's.  Then the gradient-compression cast and AdamW on the
    master, in place: the step consumes the state it is given (the returned
    state holds its master, mu and nu tensors, updated).  Metrics: the loss
    function's (``loss``, ``ce``, ``aux``, ``mtp_ce``) and ``lr``,
    ``grad_norm``.

    With ``grad_shardings`` (a tree of ``NamedSharding``, usually the ZeRO-1
    master shardings of ``opt_state_shardings``) the step runs over their
    mesh: ``mesh_train_step``."""
    if grad_shardings is not None:
        return mesh_train_step(bundle, opt_cfg, grad_shardings, stem_cfg=stem_cfg,
                               policies=policies, remat=remat,
                               microbatches=microbatches)

    def grad_of(master, mb):
        return loss_and_grads(bundle, master, mb, stem_cfg=stem_cfg,
                              policies=policies, remat=remat)

    def train_step(opt_state: optim.OptState, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = grad_of(opt_state.master, batch)
        else:
            mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                 + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                   for i in range(microbatches)]
            grads = tree_map(torch.zeros_like, opt_state.master)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(grads)[0].device)
            for mb in mbs:
                l, metrics, g = grad_of(opt_state.master, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        grads = optim.adamw.compress_grads(grads, opt_cfg)
        new_state, opt_metrics = optim.update(grads, opt_state, opt_cfg)
        return new_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def _rows(v, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a batch array on ``device``."""
    if isinstance(v, ShardedArray):
        return v.gather(device, region=((lo, hi),) + tuple((0, n) for n in v.shape[1:]))
    return v[lo:hi].to(device)


def shard_view(params: dict, device) -> dict:
    """A parameter tree in blocks as one device's forward reads it: the
    top-level leaves gathered onto ``device`` (inside
    ``sharding.context.model_parallel``, a leaf split over the model axis
    as its ``ModelShards``), the stacked layer subtrees left in blocks (each
    layer gathers its own at use)."""
    return {k: v if isinstance(v, dict) else arrays.materialize(v, device)
            for k, v in params.items()}


def _add(a: ShardedArray, b: ShardedArray) -> ShardedArray:
    """Blockwise a + b of two arrays of one layout (each stored block once)."""
    done, blocks = {}, {}
    for c, t in a.blocks.items():
        if id(t) not in done:
            with shctx.at(c):
                done[id(t)] = t + b.blocks[c]
        blocks[c] = done[id(t)]
    return ShardedArray(a.sharding, a.shape, a.dtype, blocks)


def _contribution(p: ShardedArray, grads: dict) -> ShardedArray:
    """One data shard's gradient of the parameter ``p`` (blocks as
    autograd leaves) in ``p``'s layout: each block's gradient where the
    shard's backward put it (popped from ``grads``, keyed by the leaf's
    id), the copies of one block summed in rank order, zeros for a block
    the shard did not read."""
    got: dict = {}
    for _, bounds, t in p.distinct():
        g = grads.pop(id(t), None)
        if g is not None:
            got[bounds] = g if bounds not in got else got[bounds] + g.to(got[bounds].device)
    made: dict = {}
    blocks = {}
    for c, t in p.blocks.items():
        bounds = p.index(c)
        if bounds in got:
            blocks[c] = got[bounds]
        else:
            if id(t) not in made:
                made[id(t)] = torch.zeros_like(t)
            blocks[c] = made[id(t)]
    return ShardedArray(p.sharding, p.shape, p.dtype, blocks)


def mesh_train_step(bundle, opt_cfg: optim.AdamWConfig, grad_shardings, *,
                    stem_cfg=None, policies=None, remat: bool = True,
                    microbatches: int = 1, data_shards: Optional[int] = None):
    """The train step over a ``TrainMesh`` (ref ``make_train_step`` with
    ``grad_shardings``, under ``jax.jit`` with the ZeRO-1 state shardings):
    (opt_state, batch) -> (opt_state, metrics).

    ``opt_state``'s master, mu and nu are ``ShardedArray`` trees in the
    ``grad_shardings`` layout (``place_state``), its step a tensor on the
    first data shard's device; ``batch`` maps names to ``ShardedArray``s of
    ``rules.batch_sharding`` (``data.make_global_batch``) or to tensors.
    One step:

    1. the master's blocks are all-gathered into the parameters' layout
       (``rules.param_shardings``: model-axis blocks, and for
       ``fsdp_weights`` archs data-axis blocks of ``embed`` / ``expert_mlp``
       dims), cast to the arch dtype: once a step;
    2. each data shard, in rank order, runs ``bundle.loss_fn`` on its rows
       of the batch over its model shards, inside
       ``sharding.context.model_parallel`` (forward and backward): every dim
       the rules split over ``model`` is computed by each model shard on its
       own block on its own device (attention, the encoder-decoder's cross
       attention and the SSD by heads, the MLPs by ``mlp``, the RG-LRU by
       its ``rnn`` channels, the embedding, logits and CE by ``vocab``, MoE
       experts by ``experts``), every dim they leave whole once on the data
       shard's model-0 device, which holds the residual stream, the norms
       and the router, and copies its results to the shards that read them
       (``arrays.to_model_shards`` / ``reduce_from_model_shards``).  The
       top-level leaves are taken first, each layer group's blocks inside
       the layer body (``models/transformer._group_full``, the
       encoder-decoder's layer bodies; FSDP blocks gathered over data
       there), freed after, and taken again by a rematerialized backward.
       With ``microbatches`` the global batch splits into that many
       consecutive row blocks, each split over the shards;
    3. under ``sharding.context.data_parallel`` the CE is the global mean
       and the MoE aux loss the global batch's (``moe.GlobalAux``: every
       shard's forward runs before any backward);
    4. each shard's gradient with respect to the parameter blocks (a
       block's gradient on its own coordinate's device), then the
       reduce-scatter: each master block gets the sum over the shards, in
       rank order, in fp32 on its device (``arrays.reduce_into``);
       microbatches accumulate and divide, as the reference's scan does;
    5. the gradient-compression cast, after the reduction;
    6. AdamW on every block, clipped by the global norm (each block counted
       once, in leaf then rank order), the schedule replicated.

    At a model axis of 1 no tensor-parallel code runs, and at a (1, 1)
    mesh every gather is the block itself and every sum has one term, so
    the step is the one-device step's bitwise.

    ``data_shards`` runs the forward and backward of the first that many
    data shards only (the dry run's: the others repeat them by
    construction); the loss and the update are then not the global
    batch's."""
    cfg = bundle.cfg
    shardings = tree_leaves(grad_shardings)
    if not shardings or not all(isinstance(s, rules_lib.NamedSharding) for s in shardings):
        raise ValueError("make_train_step: grad_shardings must be a tree of "
                         "sharding.rules.NamedSharding over one mesh (the master's "
                         "ZeRO-1 shardings), got "
                         f"{type(shardings[0]).__name__ if shardings else 'no leaf'}")
    mesh = shardings[0].mesh
    values, axes = bundle.abstract_params()
    param_sh = rules_lib.param_shardings(cfg, mesh, values, axes)
    del values
    coords = rules_lib.data_coords(mesh)
    devices = [mesh.device(c) for c in coords]
    n_data = len(coords)
    run = coords[:data_shards] if data_shards else coords
    tp = mesh.shape.get("model", 1)

    def model_parallel(coord):
        return shctx.model_parallel(mesh, coord) if tp > 1 else contextlib.nullcontext()
    kw = {"policies": policies} if policies else {}

    def train_step(opt_state: optim.OptState, batch: dict):
        # (1) the forward's parameters, their blocks the autograd leaves
        leaf_of: dict = {}     # id(block) -> (block, leaf): the block kept alive

        def as_leaf(t):
            if id(t) not in leaf_of:
                leaf_of[id(t)] = (t, t.detach().requires_grad_())
            return leaf_of[id(t)][1]

        params = tree_map(lambda m, sh: arrays.relayout(m, sh, cfg.torch_dtype)
                          .map_blocks(as_leaf), opt_state.master, param_sh)
        leaves = [leaf for _, leaf in leaf_of.values()]
        del leaf_of
        B = next(iter(batch.values())).shape[0]
        if B % (microbatches * n_data):
            raise ValueError(f"a batch of {B} rows does not split into {microbatches} "
                             f"microbatches over {n_data} data shards")
        rows = B // (microbatches * n_data)
        grads = loss = metrics = None
        for mb in range(microbatches):
            mbs = [{k: _rows(v, (mb * n_data + d) * rows, (mb * n_data + d + 1) * rows, dev)
                    for k, v in batch.items()} for d, dev in enumerate(devices)]
            l, metrics, red = _microbatch(params, leaves, mbs, opt_state.master)
            if microbatches == 1:
                grads, loss = red, l
            else:
                if grads is None:
                    grads = tree_map(lambda m: m.map_blocks(
                        lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), torch.float32),
                                     opt_state.master)
                    loss = torch.zeros((), dtype=torch.float32, device=devices[0])
                grads = tree_map(_add, grads, red)
                loss = loss + l
        if microbatches > 1:
            grads = tree_map(lambda g: g.map_blocks(lambda t: t / microbatches), grads)
            loss = loss / microbatches
        # (5) compression after the reduction; (6) AdamW on the blocks
        grads = optim.adamw.compress_grads(grads, opt_cfg)
        g_leaves, m_leaves = tree_leaves(grads), tree_leaves(opt_state.master)
        gnorm = optim.adamw.global_norm([t for g in g_leaves for _, t in g.unique_blocks()])
        items = [(g.blocks[c], t, mu.blocks[c], nu.blocks[c])
                 for g, m, mu, nu in zip(g_leaves, m_leaves, tree_leaves(opt_state.mu),
                                         tree_leaves(opt_state.nu))
                 for c, _, t in m.distinct()]
        new, opt_metrics = optim.update(
            [i[0] for i in items],
            optim.OptState(opt_state.step, [i[1] for i in items], [i[2] for i in items],
                           [i[3] for i in items]), opt_cfg, gnorm=gnorm)
        state = optim.OptState(new.step, opt_state.master, opt_state.mu, opt_state.nu)
        return state, {**metrics, **opt_metrics, "loss": loss}

    def _microbatch(params, leaves, mbs, master):
        """One microbatch over the data shards: (loss, metrics, the
        reduce-scattered gradient tree in the master's layout)."""
        mask_total = None
        if "loss_mask" in mbs[0]:
            mask_total = sum(mb["loss_mask"].float().sum().to(devices[0]) for mb in mbs)
        aux = moe.GlobalAux(cfg.moe) if cfg.moe is not None and n_data > 1 else None
        ctx = (shctx.data_parallel(n_data, mask_total, aux) if n_data > 1
               else contextlib.nullcontext())
        outs, pending, grads = [], [], []

        def backward(loss_d):
            g = torch.autograd.grad(loss_d, leaves, allow_unused=True)
            return {id(t): gt for t, gt in zip(leaves, g)}

        with ctx:
            for d, coord in enumerate(run):
                if aux is not None:
                    aux.begin_shard()
                with model_parallel(coord):
                    loss_d, met_d = bundle.loss_fn(shard_view(params, devices[d]), mbs[d],
                                                   stem_cfg=stem_cfg, remat=remat, **kw)
                    outs.append((loss_d.detach(), {k: v.detach() for k, v in met_d.items()}))
                    pending.append(loss_d)
                    if aux is None:     # nothing couples the shards: free this graph now
                        grads.append(backward(pending.pop()))
                del loss_d, met_d
            aux_total = aux.finish() if aux is not None else None
            for d in range(len(pending)):
                with model_parallel(run[d]):
                    grads.append(backward(pending[d]))
                pending[d] = None
            del pending
        if n_data == 1:
            loss, metrics = outs[0]
        else:
            lead = devices[0]
            loss = sum(l.to(lead) for l, _ in outs)
            metrics = {k: sum(m[k].to(lead) for _, m in outs) for k in outs[0][1]}
            if aux_total is not None:
                metrics["aux"] = aux_total
                loss = loss + aux_total
            metrics["loss"] = loss

        def one(m, p):
            # each shard's gradient blocks leave ``grads`` as they are
            # reduced, so the arch-dtype gradients and their fp32 sums are
            # not all alive at once
            return arrays.reduce_into(m, [_contribution(p, g) for g in grads])
        return loss, metrics, tree_map(one, master, params)

    return train_step


def place_state(state: optim.OptState, state_sh: optim.OptState) -> optim.OptState:
    """A one-device ``OptState`` placed in ``state_sh``'s blocks; the step
    on the first coordinate's device.  A block that is a contiguous part of
    a leaf on its own device is a view of it: the state given is consumed
    (its tensors are updated in place by the mesh steps)."""
    lead = state_sh.step.mesh.devices[0]
    put = lambda t, sh: arrays.place(t, sh, copy=False)
    return optim.OptState(step=state.step.to(lead),
                          master=tree_map(put, state.master, state_sh.master),
                          mu=tree_map(put, state.mu, state_sh.mu),
                          nu=tree_map(put, state.nu, state_sh.nu))


def gather_state(state: optim.OptState, device="cpu") -> optim.OptState:
    """A mesh ``OptState`` as one-device tensors on ``device``."""
    get = lambda a: a.gather(device) if isinstance(a, ShardedArray) else a.to(device)
    return optim.OptState(step=state.step.to(device), master=tree_map(get, state.master),
                          mu=tree_map(get, state.mu), nu=tree_map(get, state.nu))


def opt_state_shardings(cfg, mesh, param_sh, abstract_values=None) -> optim.OptState:
    """The OptState's shardings: the parameters', plus ZeRO-1 over the data
    (and pod) axes when ``abstract_values`` gives the shapes; the step
    replicated."""
    rep = rules_lib.NamedSharding(mesh, ())
    opt_sh = param_sh
    if abstract_values is not None:
        opt_sh = rules_lib.zero1_shardings(cfg, mesh, abstract_values, param_sh)
    return optim.OptState(step=rep, master=opt_sh, mu=opt_sh, nu=opt_sh)


def train_arg_shardings(cfg, mesh, abstract_values, axes_tree, batch_specs):
    param_sh = rules_lib.param_shardings(cfg, mesh, abstract_values, axes_tree)
    state_sh = opt_state_shardings(cfg, mesh, param_sh)
    batch_sh = rules_lib.batch_sharding(cfg, mesh, batch_specs)
    return state_sh, batch_sh


def abstract_opt_state(abstract_values, opt_cfg: Optional[optim.AdamWConfig] = None):
    """The OptState's shapes and dtypes on the ``meta`` device."""
    mdt = (torch.bfloat16 if (opt_cfg and opt_cfg.moment_dtype == "bfloat16")
           else torch.float32)
    like = lambda dt: (lambda v: torch.empty(v.shape, dtype=dt, device="meta"))
    return optim.OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        master=tree_map(like(torch.float32), abstract_values),
        mu=tree_map(like(mdt), abstract_values),
        nu=tree_map(like(mdt), abstract_values))


def make_unified_step(bundle, *, stem_cfg, budget_frac: float = 1.0,
                      chunk_k_max: int = 0, sampler=None, smesh=None):
    """(params, pools, tokens (S, 1), page_table (S, P), cache_lens (S,),
    chunk) -> (decode logits (S, vocab), chunk logits (L, vocab) | None,
    pools), one mixed batch per call (``transformer.paged_mixed_step``).

    With ``sampler`` the step is the async engine's sampled one
    (``transformer.paged_sampled_step``): (params, pools, token_buf
    (S + 1,), dec_mask (S,), page_table, cache_lens, chunk) -> (dec_ids
    (S,), chunk_ids (L,) | None, token_buf, pools); ``chunk`` then also
    carries ``slot`` and ``emit``.

    Every layer reads the paged backend from ``policy.executor`` ("fused" |
    "gather").

    With ``smesh`` (a ``sharding.serving.ServingMesh``; ref
    ``src/repro/launch/steps.py:144-325``) the step drives every slot group
    of the mesh in one call, group after group, where the reference maps
    ``shard_map`` + ``vmap`` over them.  ``params`` is
    ``serving.replicate_params``' ``{device: tree}``, ``pools`` the
    engine's list of one ``serving.HeadShards`` a group, and every batch
    argument gains the reference's leading ``(dp, ...)`` axis: a tensor or
    a sequence indexed by group first (tokens (dp, S, 1), page_table (dp,
    S, P), cache_lens (dp, S), chunk leaves (dp, L, ...); sampled:
    token_buf a sequence of the groups' ``(S + 1,)`` buffers, dec_mask
    (dp, S), ``chunk["slot"]`` group-local).  Group ``g``'s slice moves to
    its lead device ``(g, 0)`` (no copy when it is there already), which
    runs the projections, the MLP and the logits; each attention layer
    runs the group's tp shards on their own devices.  Outputs are
    per-group lists in group order: decode logits (S, vocab) and chunk
    logits (L, vocab) | None, or sampled (S,) / (L,) ids and the groups'
    token buffers."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    policy_lib.get_paged_executor(policy.executor)   # unknown names raise now
    if smesh is not None:
        return _mesh_unified_step(cfg, smesh, policy, budget_frac,
                                  chunk_k_max, sampler)

    if sampler is None:
        def unified_step(params, pools, tokens, page_table, cache_lens,
                         chunk=None):
            return transformer.paged_mixed_step(
                params, tokens, pools, page_table, cache_lens, cfg,
                stem_cfg=policy, budget_frac=budget_frac, chunk=chunk,
                chunk_k_max=chunk_k_max)
        return unified_step

    def unified_sampled(params, pools, token_buf, dec_mask, page_table,
                        cache_lens, chunk=None):
        return transformer.paged_sampled_step(
            params, token_buf, pools, page_table, cache_lens, dec_mask, cfg,
            stem_cfg=policy, sampler=sampler, budget_frac=budget_frac,
            chunk=chunk, chunk_k_max=chunk_k_max)
    return unified_sampled


def _mesh_unified_step(cfg, smesh, policy, budget_frac: float,
                       chunk_k_max: int, sampler):
    """``make_unified_step``'s mesh form: one call advances every slot
    group."""
    def group_args(g, chunk):
        dev = smesh.device(g, 0)
        return dev, (None if chunk is None
                     else {k: v[g].to(dev) for k, v in chunk.items()})

    if sampler is None:
        def unified_step(params, pools, tokens, page_table, cache_lens,
                         chunk=None):
            dec, chunks = [], []
            for g in range(smesh.dp):
                dev, ch = group_args(g, chunk)
                d, c, _ = transformer.paged_mixed_step(
                    params[dev], tokens[g].to(dev), pools[g],
                    page_table[g].to(dev), cache_lens[g].to(dev), cfg,
                    stem_cfg=policy, budget_frac=budget_frac, chunk=ch,
                    chunk_k_max=chunk_k_max)
                dec.append(d)
                chunks.append(c)
            return dec, None if chunk is None else chunks, pools
        return unified_step

    def unified_sampled(params, pools, token_buf, dec_mask, page_table,
                        cache_lens, chunk=None):
        dec, chunks = [], []
        for g in range(smesh.dp):
            dev, ch = group_args(g, chunk)
            d, c, _, _ = transformer.paged_sampled_step(
                params[dev], token_buf[g], pools[g], page_table[g].to(dev),
                cache_lens[g].to(dev), dec_mask[g].to(dev), cfg,
                stem_cfg=policy, sampler=sampler, budget_frac=budget_frac,
                chunk=ch, chunk_k_max=chunk_k_max)
            dec.append(d)
            chunks.append(c)
        return dec, None if chunk is None else chunks, token_buf, pools
    return unified_sampled


def make_prefill_step(bundle, *, max_len: int, stem_cfg=None, policies=None):
    """(params, batch) -> (last-position logits, caches): the one-shot
    prefill (``transformer.prefill``)."""
    def prefill_step(params, batch):
        kw = {"policies": policies} if policies else {}
        return bundle.prefill(params, batch, max_len=max_len,
                              stem_cfg=stem_cfg, **kw)
    return prefill_step


def set_cache_positions(caches, cache_lens):
    """Pin every attention / MLA cache's write position to per-sequence
    lengths (``(b,)`` int).  Cache leaves are stacked ``(n_layers, ...)``,
    so the position leaf becomes ``(n_layers, b)`` and each layer reads its
    ``(b,)`` row."""
    def fix(c):
        if isinstance(c, (attention.KVCache, mla.MLACache)) and isinstance(c.pos, ShardedArray):
            mesh = c.pos.mesh       # a mesh step's caches: the positions replicated
            lens = torch.as_tensor(cache_lens, dtype=torch.int32, device=mesh.devices[0])
            pos = lens.expand((c[0].shape[0],) + lens.shape).contiguous()
            return c._replace(pos=arrays.place(pos, rules_lib.NamedSharding(mesh, ())))
        if isinstance(c, (attention.KVCache, mla.MLACache)):
            lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                                   device=c.pos.device)
            return c._replace(pos=lens.expand((c[0].shape[0],) + lens.shape))
        if isinstance(c, dict):
            return {k: fix(v) for k, v in c.items()}
        if isinstance(c, list):
            return [fix(v) for v in c]
        if isinstance(c, tuple) and hasattr(c, "_fields"):     # DecLayerCache
            return type(c)(*(fix(v) for v in c))
        return c
    return fix(caches)


def make_serve_step(bundle, *, stem_cfg=None, budget_frac: float = 1.0):
    """(params, tokens, caches[, cache_lens]) -> (logits, caches).

    ``cache_lens`` (``(b,)`` int) overrides the caches' write positions per
    sequence — the ragged fixed-batch path: each row decodes against its
    own prompt length.  Positions advance inside the caches afterwards, so
    pass it only on the first step.

    With ``stem_cfg`` the decode is policy-sparse over the contiguous cache
    (``attention.apply_decode`` summarizes + selects every step) — the
    fixed-batch reference arm for the paged engine's sparse decode."""
    def serve_step(params, tokens, caches, cache_lens=None):
        if cache_lens is not None:
            caches = set_cache_positions(caches, cache_lens)
        if stem_cfg is None:
            return bundle.decode_step(params, tokens, caches)
        return bundle.decode_step(params, tokens, caches,
                                  stem_cfg=stem_cfg, budget_frac=budget_frac)
    return serve_step


def _cache_map(fn, tree, *rest, field=None):
    """``fn(field, leaf, *rest_leaves)`` over a cache tree (lists, dicts and
    NamedTuple caches; ``field`` the leaf's NamedTuple field name)."""
    if isinstance(tree, list):
        return [_cache_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return {k: _cache_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cache_map(fn, v, *(r[i] for r in rest), field=f)
                            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    return fn(field, tree, *rest)


class _MeshServing:
    """What the mesh prefill and serve steps share: the data shards of
    ``mesh`` (each one's model-0 coordinate, device and model shards), the
    first ``data_shards`` of them run, and the assembly of the shards'
    outputs into ``ShardedArray``s in the reference's output shardings."""

    def __init__(self, bundle, mesh, data_shards: Optional[int]):
        self.cfg, self.mesh = bundle.cfg, mesh
        values, axes = bundle.abstract_params()
        self.param_sh = rules_lib.param_shardings(self.cfg, mesh, values, axes)
        self.coords = rules_lib.data_coords(mesh)
        self.devices = [mesh.device(c) for c in self.coords]
        self.run = self.coords[:data_shards] if data_shards else self.coords
        self.tp = mesh.shape.get("model", 1)
        self.model_coords = [shctx.model_shards_of(mesh, c).coords if self.tp > 1 else (c,)
                             for c in self.coords]

    def model_parallel(self, coord):
        return (shctx.model_parallel(self.mesh, coord) if self.tp > 1
                else contextlib.nullcontext())

    def shards(self, batch_size: int) -> list:
        """[(data shard, its rows [lo, hi))] to run: each data shard its
        block of the batch where the data axes divide it; else (the rules
        replicate the batch: the long-context cell's one row) the first
        data shard every row, its outputs every data shard's, which only a
        run of that one shard may take (``data_shards=1``)."""
        n = len(self.coords)
        if batch_size % n:
            if len(self.run) > 1:
                raise ValueError(f"a batch of {batch_size} rows does not split over {n} "
                                 "data shards (the rules replicate it; run one data "
                                 "shard: data_shards=1)")
            return [(0, (0, batch_size))]
        return [(d, (d * batch_size // n, (d + 1) * batch_size // n))
                for d in range(len(self.run))]

    def outputs(self, outs: list, batch_size: int) -> list:
        """The run data shards' outputs, one a data shard: the first
        shard's for every shard where the batch is replicated."""
        return outs * len(self.coords) if batch_size % len(self.coords) else outs

    def assemble(self, outs: list, sharding, shape, dtype) -> ShardedArray:
        """The ShardedArray whose blocks are the run data shards' outputs:
        ``outs[d]`` data shard ``d``'s (a tensor, or one part a model shard:
        ``arrays.ModelShards`` / ``common.VocabShards``).  Each block must be
        the sharding's block at its coordinate; a data shard not run (the
        dry run's) gets empty blocks."""
        idx = sharding.indices(shape)
        blocks = {}
        for d, (dc, mcs) in enumerate(zip(self.coords, self.model_coords)):
            for t, c in enumerate(mcs):
                want = tuple(len(range(*sl.indices(n))) for sl, n in zip(idx[c], shape))
                if d >= len(outs):
                    with shctx.at(c):
                        blocks[c] = torch.empty(want, dtype=dtype, device=self.mesh.device(c))
                    continue
                leaf = outs[d]
                blk = leaf.parts[t] if hasattr(leaf, "parts") else leaf
                if tuple(blk.shape) != want:
                    raise AssertionError(f"the block at {c} is {tuple(blk.shape)}, its "
                                         f"sharding {sharding.spec} of {tuple(shape)} "
                                         f"gives {want}")
                blocks[c] = blk.to(self.mesh.device(c))
        return ShardedArray(sharding, shape, dtype, blocks)

    def logits(self, outs: list, batch_size: int) -> ShardedArray:
        """The last-position logits in the reference's ``("batch", "vocab")``
        sharding, left split by vocab."""
        rules = rules_lib.logical_rules(self.cfg, self.mesh)
        shape = (batch_size, self.cfg.padded_vocab)
        sh = rules_lib.NamedSharding(self.mesh, rules_lib.spec_for(
            shape, ("batch", "vocab"), rules, self.mesh))
        return self.assemble(outs, sh, shape, torch.float32)

    def positions(self, outs: list, old: Optional[ShardedArray], sharding) -> ShardedArray:
        """A ``pos`` leaf, replicated: the data shards' (L,) positions (one
        value for every row: the first shard's) or their (L, b) rows
        concatenated (a data shard not run keeps its old rows, advanced)."""
        lead = self.devices[0]
        if outs[0].ndim == 1 or (old is not None and old.shape[1] == outs[0].shape[1]):
            return arrays.place(outs[0].to(lead), sharding, copy=False)
        rows = [o.to(lead) for o in outs]
        if len(rows) < len(self.coords):
            full = old.gather(lead)
            per = full.shape[1] // len(self.coords)
            rows += [full[:, d * per:(d + 1) * per] + 1
                     for d in range(len(rows), len(self.coords))]
        return arrays.place(torch.cat(rows, dim=1), sharding, copy=False)


def mesh_prefill_step(bundle, mesh, *, max_len: int, stem_cfg=None, policies=None,
                      data_shards: Optional[int] = None):
    """The one-shot prefill over a ``TrainMesh`` (ref ``make_prefill_step``
    under ``jax.jit`` with the dry run's shardings): (params, batch) ->
    (last-position logits, caches).

    ``params`` is a ``ShardedArray`` tree in ``rules.param_shardings``'
    blocks (``arrays.place``), ``batch`` maps names to ``ShardedArray``s of
    ``rules.batch_sharding`` or to tensors.  Each data shard, in rank
    order, runs ``bundle.prefill`` on its rows over its model shards
    inside ``sharding.context.model_parallel`` (at a model axis above 1),
    as ``mesh_train_step``'s forward does: attention and MLA by heads, the
    MLPs by ``mlp``, the SSD and RG-LRU by their heads / channels, MoE
    experts, the embedding and logits by ``vocab``.  Every cache leaf is
    made at its coordinate in ``rules.cache_shardings``' layout (KV caches
    by KV heads where the rules split them, else by sequence; MLA's latents
    by sequence; the SSD / RG-LRU states and conv tails by heads /
    channels; the positions replicated).

    Returns the logits as a ``ShardedArray`` (b, padded vocab) in the
    reference's ``("batch", "vocab")`` sharding (split by vocab over the
    model axis, never gathered whole) and the caches as a tree of
    ``ShardedArray``s in ``rules.cache_shardings``.  At a (1, 1) mesh every
    block is the one-device step's tensor, bitwise.

    ``data_shards`` runs the first that many data shards only (the dry
    run's); the other shards' output blocks are left empty."""
    ms = _MeshServing(bundle, mesh, data_shards)
    kw = {"policies": policies} if policies else {}

    def prefill_step(params, batch: dict):
        B = next(iter(batch.values())).shape[0]
        logits, caches = [], []
        for d, (lo, hi) in ms.shards(B):
            coord, dev = ms.coords[d], ms.devices[d]
            mb = {k: _rows(v, lo, hi, dev) for k, v in batch.items()}
            with ms.model_parallel(coord):
                lg, cache = bundle.prefill(shard_view(params, dev), mb, max_len=max_len,
                                           stem_cfg=stem_cfg, **kw)
            logits.append(lg)
            caches.append(cache)
        logits, caches = ms.outputs(logits, B), ms.outputs(caches, B)
        n_data = len(ms.coords) if B % len(ms.coords) == 0 else 1

        def whole(field, leaf):
            """The global leaf's shape and dtype (no tensor: nothing is
            allocated, nothing counted)."""
            shape = tuple(leaf.shape)
            if len(shape) >= 2:
                shape = (shape[0], shape[1] * n_data) + shape[2:]
            return types.SimpleNamespace(shape=torch.Size(shape), dtype=getattr(
                leaf, "dtype", None) or leaf.parts[0].dtype)
        shapes = _cache_map(whole, caches[0])
        cache_sh = rules_lib.cache_shardings(ms.cfg, mesh, shapes)

        def build(field, shape, sh, *outs):
            if field == "pos":
                return ms.positions(list(outs), None, sh)
            return ms.assemble(list(outs), sh, shape.shape, shape.dtype)
        return ms.logits(logits, B), _cache_map(build, shapes, cache_sh, *caches)

    return prefill_step


def mesh_serve_step(bundle, mesh, *, stem_cfg=None, budget_frac: float = 1.0,
                    data_shards: Optional[int] = None):
    """The decode step over a ``TrainMesh`` (ref ``make_serve_step`` under
    ``jax.jit`` with the dry run's shardings, its caches donated):
    (params, tokens, caches[, cache_lens]) -> (logits, caches).

    ``params`` as ``mesh_prefill_step`` takes them, ``tokens`` (b, 1) a
    ``ShardedArray`` of ``rules.batch_sharding`` or a tensor, ``caches``
    the tree of ``ShardedArray``s ``mesh_prefill_step`` returns.
    ``cache_lens`` ((b,) int) pins every KV / latent cache's write
    positions per row (``set_cache_positions``: the ragged path); pass it
    on the first step only.  Each data shard decodes its rows over its
    model shards inside ``sharding.context.model_parallel``, every cache
    block read and written in place at its coordinate (a KV cache split by
    sequence writes each row's token on the shard holding its position and
    combines the shards' partial softmaxes: ``attention.apply_decode``).
    Returns the logits as ``mesh_prefill_step`` does and the caches: the
    same blocks, updated, with new ``pos`` leaves (replicated).  With
    ``stem_cfg`` the decode is policy-sparse, as ``make_serve_step``'s.
    At a (1, 1) mesh the step is the one-device step's, bitwise.

    ``data_shards`` as in ``mesh_prefill_step``: the caches of the data
    shards not run are left as they were."""
    ms = _MeshServing(bundle, mesh, data_shards)
    kw = {} if stem_cfg is None else {"stem_cfg": stem_cfg, "budget_frac": budget_frac}

    def serve_step(params, tokens, caches, cache_lens=None):
        if cache_lens is not None:
            caches = set_cache_positions(caches, cache_lens)
        B = tokens.shape[0]
        logits, poss = [], []
        for d, (lo, hi) in ms.shards(B):
            coord, dev = ms.coords[d], ms.devices[d]

            def view(field, leaf):
                if field == "pos":
                    region = None if len(leaf.shape) == 1 else ((0, leaf.shape[0]), (lo, hi))
                    return leaf.gather(dev, region=region, coord=coord)
                if ms.tp == 1:
                    return leaf.blocks[coord]
                mcs = ms.model_coords[d]
                dim = arrays.model_dim(leaf.sharding)
                return arrays.ModelShards(
                    [leaf.blocks[c] for c in mcs], dim,
                    None if dim is None else [leaf.index(c)[dim] for c in mcs],
                    (leaf.shape[0], hi - lo) + tuple(leaf.shape[2:]))
            with ms.model_parallel(coord):
                lg, new = bundle.decode_step(shard_view(params, dev), _rows(tokens, lo, hi, dev),
                                             _cache_map(view, caches), **kw)
            logits.append(lg)
            poss.append(new)

        def build(field, leaf, *outs):
            if field == "pos":
                return ms.positions(list(outs), leaf, leaf.sharding)
            return leaf
        return ms.logits(ms.outputs(logits, B), B), _cache_map(build, caches, *poss)

    return serve_step


def make_monolithic_prefill(bundle, *, stem_cfg, sampler=None):
    """(params, tokens (1, Lp), true_len, pools, page_row) -> (next-token
    logits (vocab,), pools) — or, with ``sampler``, (the sampled first
    token id as a 0-d int32 tensor on the device, pools).

    The one-shot admission prefill: one request, right-padded to a page
    multiple, written into the pools with its block summaries
    (``transformer.prefill_kv_pages``).  ``policy.executor`` ("fused" |
    "gather" | "dense") picks the prefill backend."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    policy_lib.get_executor(policy.executor)         # unknown names raise now

    def monolithic_prefill(params, tokens, true_len, pools, page_row):
        logits, pools = transformer.prefill_kv_pages(
            params, tokens, true_len, pools, page_row, cfg, policy)
        if sampler is not None:
            return sampler(logits), pools
        return logits, pools
    return monolithic_prefill
