"""One wrapper per kernel: check, allocate, dispatch, count.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and dispatches by the operands' device: CPU tensors go to the
plain version in :mod:`repro_torch.kernels.ref`, CUDA tensors to the CUDA
kernel on the current stream.  There is no fallback: a CUDA operand the
kernel cannot take raises.

``LAUNCHES`` counts kernel launches and ``PLAIN`` counts calls that went to
a plain version, per kernel; the gather kernel's per-row-threshold and
squared-rows variants and ``segment_update``'s accumulating one count
under their own names (``esicp_gather_ta``, ``sparse_sim_square``,
``segment_update_init``).  A run resets them with :func:`reset_counts`
and reads them after, to show which path it took.

The two gathers take ``tuned=`` (a :class:`repro_torch.tune.TunedConfig`)
and launch at its tile setting; the square and per-row-threshold variants
have setting 0 only.  On CPU tensors the config is checked and ignored:
the plain versions have no tiles.

Gradients: on the CPU the plain versions are plain torch code, and
autograd through them is the reference (its backward through
:func:`flash_attention` or :func:`slstm_scan` counts in ``PLAIN`` as
``flash_attention_bwd`` or ``slstm_scan_bwd``).  A CUDA operand of either
that needs a gradient (grad mode on) goes through the kernel's autograd
Function, whose backward is a kernel too (counted in ``LAUNCHES`` under
those names), so no kernel output that a gradient must cross lacks a
``grad_fn``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

KERNELS = ("esicp_gather", "esicp_filter", "segment_update", "rho_gather",
           "sparse_sim", "esicp_gather_ta", "sparse_sim_square", "doc_sketch",
           "sketch_sim", "flash_attention", "segment_update_init",
           "routed_scan", "slstm_scan", "flash_attention_bwd",
           "slstm_scan_bwd")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN[name] = 0


def _on_cuda(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _need(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")


def _contiguous(*named) -> None:
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _check_tuples(ids, vals):
    _need(ids, "ids", torch.int32, 2)
    _need(vals, "vals", torch.float32, 2)
    if ids.shape != vals.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and vals "
                         f"{tuple(vals.shape)} differ")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain_backward_counted(out, name: str):
    """``out`` of a plain version, its backward through autograd counted
    in PLAIN[name] when it runs."""
    def count(grad):
        PLAIN[name] += 1

    if out.requires_grad:
        out.register_hook(count)
    return out


def _setting(tuned, gather: str, counts: bool) -> int:
    """The tile setting (0-7) ``tuned`` gives ``gather`` ('sims' or
    'esicp'; None: the square and ta variants, setting 0)."""
    if tuned is None:
        return 0
    from repro_torch.tune.config import TunedConfig, instantiated

    if not isinstance(tuned, TunedConfig):
        raise TypeError(f"tuned must be a TunedConfig, got "
                        f"{type(tuned).__name__}")
    if gather is None:
        return 0
    setting = tuned.launch_setting(gather)
    if not instantiated(gather, counts, setting):
        raise ValueError(f"gather.cu has no {gather} setting {setting} "
                         f"{'with' if counts else 'without'} counts")
    return setting


def _check_gather(ids, vals, means_t, mode: int, setting: int):
    _check_tuples(ids, vals)
    _need(means_t, "means_t", torch.float32, 2)
    on_cuda = _on_cuda(ids, vals, means_t)
    if on_cuda:
        _contiguous(("ids", ids), ("vals", vals), ("means_t", means_t))
        from repro_torch.kernels.esicp_gather import library

        if ids.shape[0] > library().gather_max_rows(mode, setting):
            raise ValueError(f"{ids.shape[0]} rows exceed one gather launch "
                             f"at tile setting {setting}; pass the rows in "
                             "batches")
    return on_cuda


def sparse_sim(ids, vals, means_t, *, with_counts: bool = False,
               square: bool = False, tuned=None):
    """(B, K) float32 sims [and (B, K) int32 counts, else None].

    ``square`` gathers m² in place of m (Σ v·m², counted as
    ``sparse_sim_square``); it takes no counts and launches setting 0.
    ``tuned``: the :class:`repro_torch.tune.TunedConfig` whose
    ``sims_setting`` and grid order the launch takes (None: setting 0).
    """
    from repro_torch.kernels.esicp_gather import SIMS, SQUARE

    if square and with_counts:
        raise ValueError("the squared variant computes no counts")
    name = "sparse_sim_square" if square else "sparse_sim"
    setting = _setting(tuned, None if square else "sims", with_counts)
    if not _check_gather(ids, vals, means_t, SQUARE if square else SIMS,
                         setting):
        PLAIN[name] += 1
        return ref.sparse_sim(ids, vals, means_t, with_counts=with_counts,
                              square=square)
    from repro_torch.kernels import sparse_sim as kern

    b, k = ids.shape[0], means_t.shape[1]
    sims = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    counts = (torch.empty((b, k), dtype=torch.int32, device=ids.device)
              if with_counts else None)
    if b and k:
        kern.launch(ids, vals, means_t, means_t.shape[0], sims, counts,
                    square=square, setting=setting)
        LAUNCHES[name] += 1
    return sims, counts


def esicp_gather(ids, vals, means_t, t_th, v_th, *, with_counts: bool = False,
                 v_ta=None, tuned=None):
    """(rho12, y, sims) float32 (B, K) [and int32 counts, else None].

    ``v_ta`` (B,) float32 replaces the shared ``v_th`` by a threshold per
    row (TA-ICP; counted as ``esicp_gather_ta``; setting 0).  ``tuned``:
    the :class:`repro_torch.tune.TunedConfig` whose ``esicp_setting`` and
    grid order the launch takes (None: setting 0).
    """
    from repro_torch.kernels.esicp_gather import ESICP, TA

    setting = _setting(tuned, None if v_ta is not None else "esicp",
                       with_counts)
    on_cuda = _check_gather(ids, vals, means_t,
                            TA if v_ta is not None else ESICP, setting)
    name = "esicp_gather"
    if v_ta is not None:
        name = "esicp_gather_ta"
        _need(v_ta, "v_ta", torch.float32, 1)
        if v_ta.shape[0] != ids.shape[0]:
            raise ValueError("v_ta must have one entry per row")
        if _on_cuda(ids, v_ta):
            _contiguous(("v_ta", v_ta))
    if not on_cuda:
        PLAIN[name] += 1
        return ref.esicp_gather(ids, vals, means_t, t_th, v_th,
                                with_counts=with_counts, v_ta=v_ta)
    from repro_torch.kernels import esicp_gather as kern

    b, k = ids.shape[0], means_t.shape[1]
    out = lambda dt: torch.empty((b, k), dtype=dt, device=ids.device)
    rho12, y, sims = out(torch.float32), out(torch.float32), out(torch.float32)
    counts = out(torch.int32) if with_counts else None
    if b and k:
        if v_ta is None:
            kern.launch(ids, vals, means_t, means_t.shape[0], t_th, v_th,
                        rho12, y, sims, counts, setting=setting)
        else:
            kern.launch_ta(ids, vals, means_t, means_t.shape[0], t_th, v_ta,
                           rho12, y, sims, counts)
        LAUNCHES[name] += 1
    return rho12, y, sims, counts


def esicp_filter(rho12, y, rho_max, col_ok, v_th):
    """(mask (B, K) bool, count (B,) int32)."""
    _need(rho12, "rho12", torch.float32, 2)
    _need(y, "y", torch.float32, 2)
    _need(rho_max, "rho_max", torch.float32, 1)
    _need(col_ok, "col_ok", torch.bool, 2)
    if not (rho12.shape == y.shape == col_ok.shape
            and rho_max.shape == rho12.shape[:1]):
        raise ValueError("esicp_filter operands disagree in shape")
    if not _on_cuda(rho12, y, rho_max, col_ok):
        PLAIN["esicp_filter"] += 1
        return ref.esicp_filter(rho12, y, rho_max, col_ok, v_th)
    from repro_torch.kernels import esicp_filter as kern

    _contiguous(("rho12", rho12), ("y", y), ("rho_max", rho_max),
                ("col_ok", col_ok))
    b, k = rho12.shape
    mask = torch.empty((b, k), dtype=torch.bool, device=rho12.device)
    count = torch.zeros((b,), dtype=torch.int32, device=rho12.device)
    if b:
        kern.launch(rho12, y, rho_max, col_ok, v_th, mask, count)
        LAUNCHES["esicp_filter"] += 1
    return mask, count


def segment_update(assign, docs, *, k: int, init=None):
    """(D, K) float32 transposed cluster sums λ_t of the live tuples of
    ``docs`` (a :class:`repro_torch.sparse.matrix.SparseDocs`); assignments
    outside [0, K) contribute nothing.

    ``init`` (D, K) float32, contiguous, on the documents' device: the
    sums are added to it in place and it is returned (counted as
    ``segment_update_init``).  Chunk after chunk this gives one call's
    λ_t over all the chunks, bit for bit.

    On the card the kernel walks ``docs.by_term``, the term-major layout
    the documents build on first use and keep, so a fit sorts once.
    """
    _check_tuples(docs.ids, docs.vals)
    _need(assign, "assign", torch.int32, 1)
    if assign.shape[0] != docs.n_docs:
        raise ValueError("assign must have one entry per row")
    operands = [assign, docs.ids, docs.vals, docs.nnz]
    name = "segment_update"
    if init is not None:
        name = "segment_update_init"
        _need(init, "init", torch.float32, 2)
        if tuple(init.shape) != (docs.dim, k):
            raise ValueError(f"init must be ({docs.dim}, {k}), got "
                             f"{tuple(init.shape)}")
        if not init.is_contiguous():
            raise ValueError("init must be contiguous")
        operands.append(init)
    if not _on_cuda(*operands):
        PLAIN[name] += 1
        return ref.segment_update(assign, docs.ids, docs.live_vals(), k,
                                  docs.dim, init=init)
    from repro_torch.kernels import segment_update as kern

    _contiguous(("assign", assign))
    # The layout first: its one-off build's transients come before λ_t.
    layout = docs.by_term
    lam_t = init if init is not None else torch.empty(
        (docs.dim, k), dtype=torch.float32, device=assign.device)
    if docs.dim and k:
        kern.launch(layout, assign, lam_t, accumulate=init is not None)
        LAUNCHES[name] += 1
    return lam_t


def rho_gather(assign, ids, vals, means_t, nnz):
    """(B,) float32 ρ[b] = x_b·μ_{assign_b} (0 outside [0, K)).

    ``nnz`` (B,) int32 limits row b to its slots [0, nnz[b]) (a caller
    whose rows are all live passes P).  Each row sums in ``repro``'s
    float32 order over its padded width (:func:`repro_torch.kernels.ref.
    window_sum`, or ``short_row_sum`` up to 32 slots), which the kernel
    takes up to
    :data:`repro_torch.kernels.rho_gather.MAX_WIDTH` slots.
    """
    _check_tuples(ids, vals)
    _need(assign, "assign", torch.int32, 1)
    _need(means_t, "means_t", torch.float32, 2)
    _need(nnz, "nnz", torch.int32, 1)
    if assign.shape[0] != ids.shape[0] or nnz.shape[0] != ids.shape[0]:
        raise ValueError("assign and nnz must have one entry per row")
    operands = [("assign", assign), ("ids", ids), ("vals", vals),
                ("means_t", means_t), ("nnz", nnz)]
    if not _on_cuda(*(t for _, t in operands)):
        PLAIN["rho_gather"] += 1
        return ref.rho_gather(assign, ids, vals, means_t, nnz)
    from repro_torch.kernels import rho_gather as kern

    _contiguous(*operands)
    b, p = ids.shape
    if p > kern.MAX_WIDTH:
        raise ValueError(f"rows of {p} slots exceed the rho_gather kernel's "
                         f"{kern.MAX_WIDTH}")
    k = means_t.shape[1]
    out = torch.empty((b,), dtype=torch.float32, device=ids.device)
    if b:
        # The counting sort's bins and order, from the caching allocator.
        scratch = torch.empty((b + k + 1,), dtype=torch.int32,
                              device=ids.device)
        kern.launch(assign, ids, vals, nnz, means_t, means_t.shape[0],
                    scratch, out)
        LAUNCHES["rho_gather"] += 1
    return out


def routed_scan(ids, vals, nnz, means_t, cells, starts, sizes, cmax: int):
    """Two-level routed classify of a (B, P) batch -> (assign (B,) int32
    global fine ids, best (B,) float32, scored (B,) int32).

    ``cells`` (B, n_probe) int32 are each row's probed coarse cells, best
    first; cell c's fine centroids are ``means_t``'s columns
    [starts[c], starts[c] + sizes[c]) (``starts``/``sizes`` (K_c,) int32;
    slots past cmax are not scored).  Rows read their slots [0, nnz); a
    row whose probed cells are all empty gets column 0 at -inf.  The kernel
    trusts cells, starts and sizes to lie in range (they come from the
    model and the coarse top-n): checking them would cost a host sync.
    """
    _check_tuples(ids, vals)
    _need(nnz, "nnz", torch.int32, 1)
    _need(means_t, "means_t", torch.float32, 2)
    _need(cells, "cells", torch.int32, 2)
    _need(starts, "starts", torch.int32, 1)
    _need(sizes, "sizes", torch.int32, 1)
    b = ids.shape[0]
    if nnz.shape[0] != b or cells.shape[0] != b:
        raise ValueError("nnz and cells must have one entry per row")
    if starts.shape != sizes.shape or cells.shape[1] < 1 or cmax < 1:
        raise ValueError("starts and sizes must be (K_c,), cells (B, "
                         "n_probe >= 1), cmax >= 1")
    operands = [("ids", ids), ("vals", vals), ("nnz", nnz),
                ("means_t", means_t), ("cells", cells), ("starts", starts),
                ("sizes", sizes)]
    if not _on_cuda(*(t for _, t in operands)):
        PLAIN["routed_scan"] += 1
        return ref.routed_scan(ids, vals, nnz, means_t, cells, starts, sizes,
                               cmax)
    from repro_torch.kernels import routed_scan as kern

    _contiguous(*operands)
    dev = ids.device
    assign = torch.empty((b,), dtype=torch.int32, device=dev)
    best = torch.empty((b,), dtype=torch.float32, device=dev)
    scored = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        kern.launch(ids, vals, nnz, means_t, cells, starts, sizes, cmax,
                    assign, best, scored)
        LAUNCHES["routed_scan"] += 1
    return assign, best, scored


def slstm_scan(gates, c0, n0, m0):
    """The sLSTM scan of gates (B, S, 4D) float32 (z | i | f | o) from the
    state (c0, n0, m0) (B, D) float32 -> (hs (B, S, D), c, n, m), all
    float32 and new tensors.  On the card one launch for any S; S = 0
    launches nothing and returns copies of the state."""
    _need(gates, "gates", torch.float32, 3)
    b, s, d4 = gates.shape
    if d4 % 4:
        raise ValueError(f"gates' last dim {d4} is not 4·D")
    for name, t in (("c0", c0), ("n0", n0), ("m0", m0)):
        _need(t, name, torch.float32, 2)
        if t.shape != (b, d4 // 4):
            raise ValueError(f"{name} must be {(b, d4 // 4)}, got "
                             f"{tuple(t.shape)}")
    if not _on_cuda(gates, c0, n0, m0):
        PLAIN["slstm_scan"] += 1
        hs, c, n, m = ref.slstm_scan(gates, c0, n0, m0)
        return _plain_backward_counted(hs, "slstm_scan_bwd"), c, n, m
    from repro_torch.kernels import slstm_scan as kern

    _contiguous(("gates", gates), ("c0", c0), ("n0", n0), ("m0", m0))
    if _needs_grad(gates, c0, n0, m0):
        return kern.SlstmScan.apply(gates, c0, n0, m0)
    return kern.scan(gates, c0, n0, m0)


def doc_sketch(ids, vals, dim: int, sketch_size: int):
    """(B, S) float32 block-vector sketch of padded tuple rows: slot s is
    the L2 norm of the row's values with clip(id // g, 0, S-1) = s,
    g = ceil(dim / S)."""
    from repro_torch.kernels.sketch_sim import MAX_S

    _check_tuples(ids, vals)
    if not 1 <= sketch_size <= MAX_S:
        raise ValueError(f"sketch_size must lie in [1, {MAX_S}], got "
                         f"{sketch_size}")
    if not _on_cuda(ids, vals):
        PLAIN["doc_sketch"] += 1
        return ref.doc_sketch(ids, vals, dim, sketch_size)
    from repro_torch.kernels import sketch_sim as kern

    _contiguous(("ids", ids), ("vals", vals))
    out = torch.empty((ids.shape[0], sketch_size), dtype=torch.float32,
                      device=ids.device)
    if ids.shape[0]:
        kern.launch_doc_sketch(ids, vals, -(-dim // sketch_size), out)
        LAUNCHES["doc_sketch"] += 1
    return out


def sketch_sim(sk_docs, sketch_t):
    """(B, S) × (S, K) -> (B, K) float32 sketch similarities, S ≤ 64."""
    from repro_torch.kernels.sketch_sim import MAX_S

    _need(sk_docs, "sk_docs", torch.float32, 2)
    _need(sketch_t, "sketch_t", torch.float32, 2)
    b, s = sk_docs.shape
    if sketch_t.shape[0] != s or not 1 <= s <= MAX_S:
        raise ValueError(f"sketch widths {s} and {sketch_t.shape[0]} must "
                         f"agree and lie in [1, {MAX_S}]")
    if not _on_cuda(sk_docs, sketch_t):
        PLAIN["sketch_sim"] += 1
        return ref.sketch_sim(sk_docs, sketch_t)
    from repro_torch.kernels import sketch_sim as kern

    _contiguous(("sk_docs", sk_docs), ("sketch_t", sketch_t))
    if b > kern.library().sketch_max_rows():
        raise ValueError(f"{b} rows exceed one sketch_sim launch; pass the "
                         "rows in batches")
    k = sketch_t.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=sk_docs.device)
    if b and k:
        kern.launch(sk_docs, sketch_t, out)
        LAUNCHES["sketch_sim"] += 1
    return out


def flash_attention(q, k, v, *, window: int = -1, sk_real: int | None = None):
    """(BH, Sq, hd) x (BH, Sk, hd) -> (BH, Sq, hd) float32 banded-causal
    attention (window < 0: full causal; keys at or past ``sk_real``, default
    Sk, are masked; a row with no live key gives 0).  On the card any hd up
    to 256: one the kernel has no instantiation for runs on the next one,
    q, k and v zero-padded to it and the output sliced back."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _need(t, name, torch.float32, 3)
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    sk_real = sk if sk_real is None else int(sk_real)
    if not 0 <= sk_real <= sk:
        raise ValueError(f"sk_real {sk_real} outside [0, {sk}]")
    window = int(window)
    if not _on_cuda(q, k, v):
        PLAIN["flash_attention"] += 1
        return _plain_backward_counted(
            ref.flash_attention(q, k, v, window, sk_real),
            "flash_attention_bwd")
    from repro_torch.kernels import flash_attention as kern

    _contiguous(("q", q), ("k", k), ("v", v))
    hp = kern.padded_head_dim(hd)
    if hp != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, hp - hd)) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned for the kernel")
    scale = 1.0 / math.sqrt(hd)
    if _needs_grad(q, k, v):
        out = kern.FlashAttention.apply(q, k, v, window, sk_real, scale)
    else:
        out = kern.attend(q, k, v, window, sk_real, scale)
    return out if hp == hd else out[..., :hd].contiguous()
