"""Carry state across from numpy arrays — the way a ``repro`` corpus, index,
state or fitted model enters the port.

Each function takes plain numpy leaves (``np.asarray`` of the ``repro``
object's fields), so this module needs nothing of ``repro``.  For a
``repro`` FittedModel ``m``::

    model = model_from_numpy(
        np.asarray(m.index.means_t), np.asarray(m.index.moving),
        int(m.index.params.t_th), float(m.index.params.v_th),
        labels=m.labels, rho_self=m.rho_self, history=m.history)

With these, a model fitted by ``repro`` classifies identically in the port,
and a ``repro`` state steps identically.  :func:`lm_params_from_numpy` does
the same for an LM's parameters (``repro.models.init_params``), and
:func:`lm_cache_from_numpy` for its decode cache; :func:`lm_params_to_numpy`
goes back (parameters or gradients, to ``repro``'s stacked layout), and
:func:`adamw_state_to_numpy` / :func:`adamw_state_from_numpy` carry an
AdamW state (``repro.train.adamw_init``'s mu, nu, count) either way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cluster.model import FittedModel
from repro_torch.core.meanindex import (MeanIndex, StructuralParams,
                                        build_mean_index)
from repro_torch.core.update import KMeansState
from repro_torch.sparse.matrix import SparseDocs


def _t(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def docs_from_numpy(ids, vals, nnz, dim: int, df=None, *,
                    device="cuda") -> SparseDocs:
    """Padded tuple arrays -> SparseDocs on ``device``."""
    dev = resolve_device(device)
    return SparseDocs(_t(ids, np.int32, dev), _t(vals, np.float32, dev),
                      _t(nnz, np.int32, dev), int(dim),
                      None if df is None else _t(df, np.int32, dev)
                      ).validate()


def index_from_numpy(means_t, moving, t_th, v_th, *,
                     device="cuda") -> MeanIndex:
    """(D, K) transposed means + moving flags + thresholds -> MeanIndex."""
    dev = resolve_device(device)
    return build_mean_index(_t(means_t, np.float32, dev),
                            StructuralParams(int(t_th), float(v_th)),
                            moving=_t(moving, np.bool_, dev))


def state_from_numpy(means_t, moving, t_th, v_th, assign, rho_self,
                     rho_self_prev, iteration, ub, *,
                     device="cuda") -> KMeansState:
    """The leaves of a ``repro`` KMeansState -> KMeansState."""
    dev = resolve_device(device)
    return KMeansState(
        index=index_from_numpy(means_t, moving, t_th, v_th, device=dev),
        assign=_t(assign, np.int32, dev),
        rho_self=_t(rho_self, np.float32, dev),
        rho_self_prev=_t(rho_self_prev, np.float32, dev),
        iteration=int(iteration),
        ub=_t(ub, np.float32, dev))


def model_from_numpy(means_t, moving, t_th, v_th, *, labels=None,
                     rho_self=None, history=(), algo: str = "esicp",
                     device="cuda") -> FittedModel:
    """The leaves of a ``repro`` FittedModel (or of its MeanIndex) ->
    FittedModel."""
    dev = resolve_device(device)
    opt = lambda a, dt: None if a is None else _t(a, dt, dev)
    history = list(history)
    return FittedModel(
        index=index_from_numpy(means_t, moving, t_th, v_th, device=dev),
        labels=opt(labels, np.int32), rho_self=opt(rho_self, np.float32),
        history=history, n_iter=len(history), algo=algo)


def lm_params_from_numpy(tree, cfg, *, device="cuda") -> dict:
    """The nested dict of numpy leaves of a ``repro`` LM parameter tree
    (``jax.tree_util.tree_map(np.asarray, params)``), whose segment leaves
    are stacked on a leading ``reps`` axis, -> the port's parameters: one
    dict per layer in execution order (see ``models/transformer.py``).
    Every kind's leaves unstack alike (a ``moe`` layer's router (reps, D,
    E) and expert stacks (reps, E, ., .), the SSM kinds' matrices and
    vectors).  ``repro``'s segments have no entry for a ``shared_attn``
    position (its ``pos{i}`` keys skip it); the unstacked top-level
    ``shared`` is converted once and every ``shared_attn`` layer is that
    dict.  ``frontend_proj`` is carried as it is."""
    dev = resolve_device(device)
    out = {name: _t(tree[name], np.float32, dev)
           for name in ("embed", "final_norm", "lm_head", "frontend_proj")
           if name in tree}
    if "shared" in tree:
        out["shared"] = {n: _t(a, np.float32, dev)
                         for n, a in tree["shared"].items()}
    layers = []
    for si, seg in enumerate(cfg.segments):
        for r in range(seg.reps):
            for pi, spec in enumerate(seg.layers):
                if spec.kind == "shared_attn":
                    layers.append(out["shared"])
                    continue
                leaves = tree[f"seg{si}"][f"pos{pi}"]
                layers.append({n: _t(a[r], np.float32, dev)
                               for n, a in leaves.items()})
    out["layers"] = layers
    return out


def lm_cache_from_numpy(tree, cfg, *, device="cuda") -> list[dict]:
    """The numpy leaves of a ``repro`` decode cache (``init_cache`` or a
    ``decode_forward`` result), stacked on ``reps`` per segment position
    (``shared_attn`` positions included: each invocation has its own K/V),
    -> the port's cache: one dict per layer in execution order, each leaf
    in its own dtype (an int8 cache's {"q", "s"} dicts kept)."""
    dev = resolve_device(device)

    def take(node, r):
        if isinstance(node, dict):
            return {n: take(a, r) for n, a in node.items()}
        return torch.from_numpy(np.array(node[r])).to(dev)

    return [take(tree[f"seg{si}"][f"pos{pi}"], r)
            for si, seg in enumerate(cfg.segments)
            for r in range(seg.reps)
            for pi in range(len(seg.layers))]


def lm_params_to_numpy(params, cfg) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the port's parameter
    (or gradient) tree -> ``repro``'s nested dict of numpy leaves, each
    segment position's layers stacked on a leading ``reps`` axis, one
    ``shared`` entry and no segment entry for a ``shared_attn``
    position."""
    def host(t):
        return t.detach().cpu().numpy()

    out = {name: host(params[name])
           for name in ("embed", "final_norm", "lm_head", "frontend_proj")
           if name in params}
    if "shared" in params:
        out["shared"] = {n: host(t) for n, t in params["shared"].items()}
    first = 0
    for si, seg in enumerate(cfg.segments):
        width = len(seg.layers)
        seg_tree = {}
        for pi, spec in enumerate(seg.layers):
            if spec.kind == "shared_attn":
                continue
            reps = [params["layers"][first + r * width + pi]
                    for r in range(seg.reps)]
            seg_tree[f"pos{pi}"] = {n: np.stack([host(lp[n]) for lp in reps])
                                    for n in reps[0]}
        out[f"seg{si}"] = seg_tree
        first += seg.reps * width
    return out


def adamw_state_to_numpy(state, cfg) -> dict:
    """An AdamW state ({"mu", "nu": parameter trees, "count": int32}) ->
    ``repro``'s layout, numpy leaves."""
    return {"mu": lm_params_to_numpy(state["mu"], cfg),
            "nu": lm_params_to_numpy(state["nu"], cfg),
            "count": np.asarray(state["count"].cpu().numpy(), np.int32)}


def adamw_state_from_numpy(tree, cfg, *, device="cuda") -> dict:
    """``repro``'s AdamW state (numpy leaves) -> the port's, on
    ``device``."""
    dev = resolve_device(device)
    return {"mu": lm_params_from_numpy(tree["mu"], cfg, device=dev),
            "nu": lm_params_from_numpy(tree["nu"], cfg, device=dev),
            "count": _t(tree["count"], np.int32, dev).reshape(())}
