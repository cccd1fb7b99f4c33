"""One wrapper per kernel: check, allocate, dispatch, count.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and dispatches by the operands' device: CPU tensors go to the
plain version in :mod:`repro_torch.kernels.ref`, CUDA tensors to the CUDA
kernel on the current stream.  There is no fallback: a CUDA operand the
kernel cannot take raises.

``LAUNCHES`` counts kernel launches and ``PLAIN`` counts calls that went to
a plain version, per kernel; the gather kernel's per-row-threshold and
squared-rows variants count under their own names (``esicp_gather_ta``,
``sparse_sim_square``).  A run resets them with :func:`reset_counts`
and reads them after, to show which path it took.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

KERNELS = ("esicp_gather", "esicp_filter", "segment_update", "rho_gather",
           "sparse_sim", "esicp_gather_ta", "sparse_sim_square", "doc_sketch",
           "sketch_sim", "flash_attention")
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


def _check_gather(ids, vals, means_t):
    _check_tuples(ids, vals)
    _need(means_t, "means_t", torch.float32, 2)
    on_cuda = _on_cuda(ids, vals, means_t)
    if on_cuda:
        _contiguous(("ids", ids), ("vals", vals), ("means_t", means_t))
        from repro_torch.kernels.esicp_gather import library

        if ids.shape[0] > library().gather_max_rows():
            raise ValueError(f"{ids.shape[0]} rows exceed one gather launch; "
                             "pass the rows in batches")
    return on_cuda


def sparse_sim(ids, vals, means_t, *, with_counts: bool = False,
               square: bool = False):
    """(B, K) float32 sims [and (B, K) int32 counts, else None].

    ``square`` gathers m² in place of m (Σ v·m², counted as
    ``sparse_sim_square``); it takes no counts.
    """
    if square and with_counts:
        raise ValueError("the squared variant computes no counts")
    name = "sparse_sim_square" if square else "sparse_sim"
    if not _check_gather(ids, vals, means_t):
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
                    square=square)
        LAUNCHES[name] += 1
    return sims, counts


def esicp_gather(ids, vals, means_t, t_th, v_th, *, with_counts: bool = False,
                 v_ta=None):
    """(rho12, y, sims) float32 (B, K) [and int32 counts, else None].

    ``v_ta`` (B,) float32 replaces the shared ``v_th`` by a threshold per
    row (TA-ICP; counted as ``esicp_gather_ta``).
    """
    on_cuda = _check_gather(ids, vals, means_t)
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
                        rho12, y, sims, counts)
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


def segment_update(assign, docs, *, k: int):
    """(D, K) float32 transposed cluster sums λ_t of the live tuples of
    ``docs`` (a :class:`repro_torch.sparse.matrix.SparseDocs`); assignments
    outside [0, K) contribute nothing.

    On the card the kernel walks ``docs.by_term``, the term-major layout
    the documents build on first use and keep, so a fit sorts once.
    """
    _check_tuples(docs.ids, docs.vals)
    _need(assign, "assign", torch.int32, 1)
    if assign.shape[0] != docs.n_docs:
        raise ValueError("assign must have one entry per row")
    if not _on_cuda(assign, docs.ids, docs.vals, docs.nnz):
        PLAIN["segment_update"] += 1
        return ref.segment_update(assign, docs.ids, docs.live_vals(), k,
                                  docs.dim)
    from repro_torch.kernels import segment_update as kern

    _contiguous(("assign", assign))
    # The layout first: its one-off build's transients come before λ_t.
    layout = docs.by_term
    lam_t = torch.empty((docs.dim, k), dtype=torch.float32,
                        device=assign.device)
    if docs.dim and k:
        kern.launch(layout, assign, lam_t)
        LAUNCHES["segment_update"] += 1
    return lam_t


def rho_gather(assign, ids, vals, means_t, nnz=None):
    """(B,) float32 ρ[b] = x_b·μ_{assign_b} (0 outside [0, K)).

    ``nnz`` (B,) int32, when given, limits row b to its slots
    [0, nnz[b]): the same ρ as the values with every slot past nnz set to
    0 (``SparseDocs.live_vals``), bit for bit, without that pass.
    """
    _check_tuples(ids, vals)
    _need(assign, "assign", torch.int32, 1)
    _need(means_t, "means_t", torch.float32, 2)
    if assign.shape[0] != ids.shape[0]:
        raise ValueError("assign must have one entry per row")
    operands = [("assign", assign), ("ids", ids), ("vals", vals),
                ("means_t", means_t)]
    if nnz is not None:
        _need(nnz, "nnz", torch.int32, 1)
        if nnz.shape[0] != ids.shape[0]:
            raise ValueError("nnz must have one entry per row")
        operands.append(("nnz", nnz))
    if not _on_cuda(*(t for _, t in operands)):
        PLAIN["rho_gather"] += 1
        return ref.rho_gather(assign, ids, vals, means_t, nnz=nnz)
    from repro_torch.kernels import rho_gather as kern

    _contiguous(*operands)
    b, k = ids.shape[0], means_t.shape[1]
    out = torch.empty((b,), dtype=torch.float32, device=ids.device)
    if b:
        # The counting sort's bins and order, from the caching allocator.
        scratch = torch.empty((b + k + 1,), dtype=torch.int32,
                              device=ids.device)
        kern.launch(assign, ids, vals, nnz, means_t, means_t.shape[0],
                    scratch, out)
        LAUNCHES["rho_gather"] += 1
    return out


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
    Sk, are masked; a row with no live key gives 0)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

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
        return ref.flash_attention(q, k, v, window, sk_real)
    from repro_torch.kernels import flash_attention as kern

    _contiguous(("q", q), ("k", k), ("v", v))
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not among the kernel's {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned for the kernel")
    if not (bh and sq and sk):
        return torch.zeros((bh, sq, hd), dtype=torch.float32, device=q.device)
    out = torch.empty((bh, sq, hd), dtype=torch.float32, device=q.device)
    kern.launch(q, k, v, window, sk_real, out)
    LAUNCHES["flash_attention"] += 1
    return out
