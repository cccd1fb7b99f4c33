"""Out-of-core corpus store (counterpart of ``repro.sparse.store``).

A :class:`DocStore` keeps the corpus on the host as ``ceil(N / C)``
uniform ``(C, P)`` chunks, memmapped ``.npy`` files (disk) or numpy arrays
(memory); the final chunk is padded with dead rows (nnz 0, ids and values
0).  Only the small per-document state of a fit lives on the device; the
tuple rows stream through :class:`ChunkPrefetcher`.  The directory format
is ``repro``'s (``store.json`` with format ``repro.sparse/doc-store-v1``,
``chunk_%05d.{ids,vals,nnz}.npy``, ``df.npy``), so a store either package
wrote opens in the other.

:class:`DocStoreBuilder` is the one-pass streaming ingest (raw rows ->
tf-idf, df-rank remap, L2 normalisation), numpy throughout and written as
``repro``'s, so the two builders write the same bytes.

:class:`SubsetStore` and :func:`partition_store` split a store by cell
for the two-level fit (:mod:`repro_torch.cluster.two_level`): lazy views
that read their rows from the parent's chunks.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sparse.matrix import SparseDocs

_META = "store.json"
STORE_FORMAT = "repro.sparse/doc-store-v1"


def _chunk_paths(directory: str, ci: int) -> dict:
    stem = os.path.join(directory, f"chunk_{ci:05d}")
    return {name: f"{stem}.{name}.npy" for name in ("ids", "vals", "nnz")}


def _tensor(a, dtype, dev: torch.device) -> torch.Tensor:
    """A torch copy of a numpy array (memmapped arrays are read-only, and
    a view of a memory store must not alias the caller's tensor)."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def _docs(ids, vals, nnz, dim: int, dev: torch.device) -> SparseDocs:
    return SparseDocs(_tensor(ids, np.int32, dev), _tensor(vals, np.float32,
                                                             dev),
                      _tensor(nnz, np.int32, dev), dim)


class DocStore:
    """N documents as ``ceil(N / C)`` uniform ``(C, P)`` host chunks.

    Backings: **memory**, a list of ``(ids, vals, nnz)`` numpy chunk tuples
    (:meth:`from_docs`; full chunks are views, the padded final chunk a
    copy), or **disk**, a directory of per-chunk ``.npy`` files and a
    ``store.json`` manifest (:meth:`open`, :class:`DocStoreBuilder`), read
    memmapped so that chunk i touches only its bytes.
    """

    def __init__(self, *, n_docs: int, dim: int, chunk_size: int,
                 pad_width: int, chunks: list | None = None,
                 directory: str | None = None, df: np.ndarray | None = None):
        if (chunks is None) == (directory is None):
            raise ValueError("exactly one of chunks= / directory= backs a store")
        self.n_docs = int(n_docs)
        self.dim = int(dim)
        self.chunk_size = int(chunk_size)
        self.pad_width = int(pad_width)
        self._chunks = chunks
        self.directory = directory
        self._df = None if df is None else np.asarray(df)
        self.n_chunks = -(-self.n_docs // self.chunk_size)
        if self.n_chunks < 1:
            raise ValueError("a DocStore needs at least one document")

    # -- geometry ----------------------------------------------------------
    @property
    def n_rows(self) -> int:
        """Total rows including the dead tail of the final chunk."""
        return self.n_chunks * self.chunk_size

    @property
    def nbytes(self) -> int:
        """Bytes of the chunk arrays (ids, vals, nnz), dead rows included."""
        return self.n_rows * (self.pad_width * 8 + 4)

    @property
    def df(self) -> np.ndarray:
        """(D,) int32 global document frequencies (counted once when the
        store holds none)."""
        if self._df is None:
            df = np.zeros((self.dim,), np.int64)
            for ci in range(self.n_chunks):
                ids, _, nnz = self.host_chunk(ci)
                live = np.arange(self.pad_width)[None, :] < nnz[:, None]
                df += np.bincount(ids[live].ravel(), minlength=self.dim)
            self._df = df.astype(np.int32)
        return self._df

    def n_valid(self, ci: int) -> int:
        """Rows of chunk ``ci`` backed by a real document."""
        return max(0, min(self.chunk_size,
                          self.n_docs - ci * self.chunk_size))

    def chunk_valid(self, ci: int) -> np.ndarray:
        """(C,) bool — True on rows backed by a real document."""
        return np.arange(self.chunk_size) < self.n_valid(ci)

    # -- chunk access ------------------------------------------------------
    def host_chunk(self, ci: int):
        """(ids, vals, nnz) numpy arrays of chunk ``ci`` (memmapped, so
        read-only, on disk stores)."""
        if not 0 <= ci < self.n_chunks:
            raise IndexError(f"chunk {ci} out of range [0, {self.n_chunks})")
        if self._chunks is not None:
            return self._chunks[ci]
        paths = _chunk_paths(self.directory, ci)
        return tuple(np.load(paths[k], mmap_mode="r")
                     for k in ("ids", "vals", "nnz"))

    def read_chunk(self, ci: int, out) -> None:
        """Copy chunk ``ci`` into ``out``, three C-contiguous numpy arrays
        of its shapes and dtypes (the prefetcher's pinned buffers).  A disk
        store reads each file straight into its array, one copy from the
        page cache and no page fault per 4 KB page as through a memmap."""
        if self._chunks is not None or not 0 <= ci < self.n_chunks:
            for dst, src in zip(out, self.host_chunk(ci)):
                np.copyto(dst, src, casting="same_kind")
            return
        paths = _chunk_paths(self.directory, ci)
        for dst, key in zip(out, ("ids", "vals", "nnz")):
            with open(paths[key], "rb") as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                if (shape != dst.shape or fortran or dtype != dst.dtype
                        or not dst.flags.c_contiguous):
                    raise ValueError(f"{paths[key]} holds {dtype} {shape}, "
                                     f"not the chunk's {dst.dtype} "
                                     f"{dst.shape}")
                if f.readinto(memoryview(dst).cast("B")) != dst.nbytes:
                    raise ValueError(f"{paths[key]} is truncated")

    def chunk(self, ci: int, *, device="cuda") -> SparseDocs:
        """Chunk ``ci`` (all C rows) as SparseDocs on ``device``."""
        return _docs(*self.host_chunk(ci), self.dim, resolve_device(device))

    def gather_rows(self, indices, *, device="cuda") -> SparseDocs:
        """The given global rows as one small SparseDocs (a host gather
        touching only their chunks; centroid seeding reads K rows)."""
        indices = np.asarray(indices)
        ids = np.zeros((len(indices), self.pad_width), np.int32)
        vals = np.zeros((len(indices), self.pad_width), np.float32)
        nnz = np.zeros((len(indices),), np.int32)
        order = np.argsort(indices // self.chunk_size, kind="stable")
        ci_prev, chunk = -1, None
        for pos in order:
            gi = int(indices[pos])
            if not 0 <= gi < self.n_docs:
                raise IndexError(f"row {gi} out of range [0, {self.n_docs})")
            ci, ri = divmod(gi, self.chunk_size)
            if ci != ci_prev:
                chunk, ci_prev = self.host_chunk(ci), ci
            ids[pos], vals[pos], nnz[pos] = (chunk[0][ri], chunk[1][ri],
                                             chunk[2][ri])
        return _docs(ids, vals, nnz, self.dim, resolve_device(device))

    def to_docs(self, *, device="cuda") -> SparseDocs:
        """Every chunk as one resident SparseDocs with the store's df
        (small stores and tests: this is what a DocStore avoids)."""
        parts = [self.host_chunk(ci) for ci in range(self.n_chunks)]
        cat = lambda j: np.concatenate([p[j] for p in parts])[:self.n_docs]
        dev = resolve_device(device)
        return SparseDocs(_tensor(cat(0), np.int32, dev),
                          _tensor(cat(1), np.float32, dev),
                          _tensor(cat(2), np.int32, dev), self.dim,
                          _tensor(self.df, np.int32, dev))

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_docs(cls, docs: SparseDocs, *, chunk_size: int | None = None,
                  df=None) -> DocStore:
        """A resident corpus (on any device) as an in-memory host store;
        ``chunk_size=None`` makes one chunk of the whole corpus."""
        n, p = docs.ids.shape
        c = int(chunk_size or n)
        ids = docs.ids.cpu().numpy().astype(np.int32, copy=False)
        vals = docs.vals.cpu().numpy().astype(np.float32, copy=False)
        nnz = docs.nnz.cpu().numpy().astype(np.int32, copy=False)
        chunks = []
        for start in range(0, n, c):
            m = min(c, n - start)
            if m == c:           # full chunk: a view, no copy
                chunks.append((ids[start:start + c], vals[start:start + c],
                               nnz[start:start + c]))
                continue
            cidx = np.zeros((c, p), np.int32)
            cval = np.zeros((c, p), np.float32)
            cnnz = np.zeros((c,), np.int32)
            cidx[:m], cval[:m], cnnz[:m] = (ids[start:start + m],
                                            vals[start:start + m],
                                            nnz[start:start + m])
            chunks.append((cidx, cval, cnnz))
        if df is None and docs._df is not None:
            df = docs._df
        if df is not None:
            df = df.cpu().numpy() if torch.is_tensor(df) else np.asarray(df)
        return cls(n_docs=n, dim=docs.dim, chunk_size=c, pad_width=p,
                   chunks=chunks, df=df)

    def subset(self, rows, *, chunk_size: int | None = None) -> SubsetStore:
        """A read-only view of the given rows (:class:`SubsetStore`)."""
        return SubsetStore(self, rows, chunk_size=chunk_size)

    @classmethod
    def open(cls, directory: str) -> DocStore:
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        if meta.get("format") != STORE_FORMAT:
            raise ValueError(f"{directory} holds no {STORE_FORMAT} store "
                             f"(found {meta.get('format')!r})")
        df_path = os.path.join(directory, "df.npy")
        df = np.load(df_path) if os.path.exists(df_path) else None
        return cls(n_docs=meta["n_docs"], dim=meta["dim"],
                   chunk_size=meta["chunk_size"], pad_width=meta["pad_width"],
                   directory=directory, df=df)

    def save(self, directory: str) -> DocStore:
        """Write the store as a disk store (chunk files, df, manifest);
        returns it reopened from disk."""
        os.makedirs(directory, exist_ok=True)
        for ci in range(self.n_chunks):
            ids, vals, nnz = self.host_chunk(ci)
            paths = _chunk_paths(directory, ci)
            np.save(paths["ids"], np.asarray(ids, np.int32))
            np.save(paths["vals"], np.asarray(vals, np.float32))
            np.save(paths["nnz"], np.asarray(nnz, np.int32))
        np.save(os.path.join(directory, "df.npy"), np.asarray(self.df))
        with open(os.path.join(directory, _META), "w") as f:
            json.dump({"format": STORE_FORMAT, "n_docs": self.n_docs,
                       "dim": self.dim, "chunk_size": self.chunk_size,
                       "pad_width": self.pad_width,
                       "n_chunks": self.n_chunks}, f)
        return DocStore.open(directory)


class SubsetStore(DocStore):
    """A lazy row-subset view of a parent :class:`DocStore` (a two-level
    fit's cell).

    It holds the (n_sub,) parent row indices, in the given order, and
    gathers each chunk's rows from the parent's chunks when it is read,
    each parent chunk once per sub-chunk.  Chunks are uniform ``(C, P)``
    with the parent's ``pad_width`` and a dead-row tail, so every fit and
    the prefetcher run on a cell as on a store.  ``df`` is not inherited:
    reading it counts the subset's own document frequencies, and the
    two-level fit passes the corpus's instead.
    """

    def __init__(self, parent: DocStore, rows, *,
                 chunk_size: int | None = None):
        rows = np.asarray(rows, np.int64).ravel()
        if rows.size and not ((rows >= 0) & (rows < parent.n_docs)).all():
            raise IndexError(f"subset rows out of range [0, {parent.n_docs})")
        if rows.size == 0:
            raise ValueError("a SubsetStore needs at least one row")
        self.parent = parent
        self.rows = rows
        # An empty chunk list: the base class then reads every chunk
        # through host_chunk (read_chunk, gather_rows, df, to_docs).
        super().__init__(n_docs=rows.size, dim=parent.dim,
                         chunk_size=min(chunk_size or parent.chunk_size,
                                        rows.size),
                         pad_width=parent.pad_width, chunks=[])

    def host_chunk(self, ci: int):
        if not 0 <= ci < self.n_chunks:
            raise IndexError(f"chunk {ci} out of range [0, {self.n_chunks})")
        c, p = self.chunk_size, self.pad_width
        g = self.rows[ci * c:(ci + 1) * c]
        ids = np.zeros((c, p), np.int32)
        vals = np.zeros((c, p), np.float32)
        nnz = np.zeros((c,), np.int32)
        pc, pr = np.divmod(g, self.parent.chunk_size)
        for chunk_i in np.unique(pc):
            at = np.flatnonzero(pc == chunk_i)
            src = self.parent.host_chunk(int(chunk_i))
            for dst, a in zip((ids, vals, nnz), src):
                dst[at] = a[pr[at]]
        return ids, vals, nnz

    def save(self, directory: str) -> DocStore:
        raise NotImplementedError(
            "a SubsetStore is a view for one fit; save the parent store "
            "instead")


def partition_store(store: DocStore, labels, n_cells: int, *,
                    chunk_size: int | None = None) -> list:
    """One :class:`SubsetStore` per cell of ``labels`` ((N,) ints), its
    rows in corpus order, and None for an empty cell."""
    labels = np.asarray(labels)
    if labels.shape != (store.n_docs,):
        raise ValueError(f"labels must be ({store.n_docs},), got "
                         f"{labels.shape}")
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_cells)
    views, start = [], 0
    for c in range(n_cells):
        stop = start + int(counts[c])
        views.append(None if stop == start else
                     store.subset(order[start:stop], chunk_size=chunk_size))
        start = stop
    return views


def as_store(docs, *, chunk_size: int | None = None) -> DocStore:
    """SparseDocs | DocStore -> DocStore (the strategies' front gate)."""
    if isinstance(docs, DocStore):
        return docs
    return DocStore.from_docs(docs, chunk_size=chunk_size)


# ---------------------------------------------------------------------------
# Streaming ingest (numpy, as repro.sparse.store.DocStoreBuilder).
# ---------------------------------------------------------------------------

class DocStoreBuilder:
    """One-pass streaming corpus ingest -> preprocessed on-disk DocStore.

    ``append`` takes raw (ids, vals) row batches in corpus order, spilling
    full raw chunks to ``<directory>/raw_*`` while counting the global
    document frequencies.  ``finalize`` streams every raw chunk once more
    through tf-idf (Eq. 15), the df-rank remap (Table I) and L2
    normalisation, pads the final chunk with dead rows, and deletes the
    raw files.
    """

    def __init__(self, directory: str, *, dim: int, chunk_size: int,
                 pad_width: int):
        self.directory = directory
        self.dim = int(dim)
        self.chunk_size = int(chunk_size)
        self.pad_width = int(pad_width)
        os.makedirs(directory, exist_ok=True)
        self._df = np.zeros((dim,), np.int64)
        self._buf = []            # pending rows: list of (ids, vals, nnz)
        self._buffered = 0
        self._n_docs = 0
        self._n_raw = 0
        self._finalized = False

    def append(self, ids, vals, nnz=None) -> DocStoreBuilder:
        """Add rows: ids (B, p<=P) int, vals (B, p) float; nnz defaults to
        each row's count of nonzero values."""
        if self._finalized:
            raise RuntimeError("builder already finalized")
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        if ids.shape != vals.shape or ids.ndim != 2:
            raise ValueError("ids/vals must be matching (B, p) arrays")
        if ids.shape[1] > self.pad_width:
            raise ValueError(f"rows have {ids.shape[1]} tuple slots > "
                             f"pad_width {self.pad_width}")
        nnz = (np.sum(vals != 0.0, axis=1).astype(np.int32)
               if nnz is None else np.asarray(nnz, np.int32))
        b, p = ids.shape
        wide_i = np.zeros((b, self.pad_width), np.int32)
        wide_v = np.zeros((b, self.pad_width), np.float32)
        wide_i[:, :p], wide_v[:, :p] = ids, vals
        live = np.arange(self.pad_width)[None, :] < nnz[:, None]
        if int(wide_i[live].max(initial=0)) >= self.dim:
            raise ValueError("term id out of range for dim")
        self._df += np.bincount(wide_i[live].ravel(), minlength=self.dim)
        self._buf.append((wide_i, np.where(live, wide_v, 0.0), nnz))
        self._buffered += b
        self._n_docs += b
        while self._buffered >= self.chunk_size:
            self._spill()
        return self

    def _take(self, n: int):
        out, taken = [], 0
        while taken < n:
            ids, vals, nnz = self._buf[0]
            take = min(n - taken, len(nnz))
            out.append((ids[:take], vals[:take], nnz[:take]))
            if take == len(nnz):
                self._buf.pop(0)
            else:
                self._buf[0] = (ids[take:], vals[take:], nnz[take:])
            taken += take
        self._buffered -= n
        return tuple(np.concatenate([o[j] for o in out]) for j in range(3))

    def _spill(self):
        ids, vals, nnz = self._take(min(self.chunk_size, self._buffered))
        stem = os.path.join(self.directory, f"raw_{self._n_raw:05d}")
        np.save(f"{stem}.ids.npy", ids)
        np.save(f"{stem}.vals.npy", vals)
        np.save(f"{stem}.nnz.npy", nnz)
        self._n_raw += 1

    def finalize(self, *, tf_idf: bool = True, normalize: bool = True,
                 remap: bool = True) -> DocStore:
        """Preprocess the spilled chunks; returns the opened disk store."""
        if self._finalized:
            raise RuntimeError("builder already finalized")
        if self._n_docs == 0:
            raise ValueError("no documents appended")
        if self._buffered:
            self._spill()
        self._finalized = True

        df = self._df
        perm = np.argsort(df, kind="stable")       # perm[new] = old
        inv = np.argsort(perm, kind="stable")      # inv[old] = new
        idf = np.log(float(self._n_docs)
                     / np.maximum(df.astype(np.float64), 1.0)).astype(np.float32)
        c, p = self.chunk_size, self.pad_width
        for ri in range(self._n_raw):
            stem = os.path.join(self.directory, f"raw_{ri:05d}")
            ids = np.load(f"{stem}.ids.npy")
            vals = np.load(f"{stem}.vals.npy")
            nnz = np.load(f"{stem}.nnz.npy")
            live = np.arange(p)[None, :] < nnz[:, None]
            if tf_idf:
                vals = np.where(live, vals * idf[ids], 0.0).astype(np.float32)
            if remap:
                new_ids = inv[ids]
                key = np.where(live, new_ids, self.dim)
                order = np.argsort(key, axis=1, kind="stable")
                ids = np.take_along_axis(
                    np.where(live, new_ids, 0), order, axis=1).astype(np.int32)
                vals = np.take_along_axis(
                    np.where(live, vals, np.float32(0.0)), order, axis=1)
            if normalize:
                norm = np.sqrt(np.sum(vals.astype(np.float64) ** 2, axis=1)
                               + 1e-12)
                vals = (vals / norm[:, None].astype(np.float32)).astype(
                    np.float32)
            if len(nnz) < c:                         # dead-row tail padding
                pad = c - len(nnz)
                ids = np.concatenate([ids, np.zeros((pad, p), np.int32)])
                vals = np.concatenate([vals, np.zeros((pad, p), np.float32)])
                nnz = np.concatenate([nnz, np.zeros((pad,), np.int32)])
            paths = _chunk_paths(self.directory, ri)
            np.save(paths["ids"], ids)
            np.save(paths["vals"], vals)
            np.save(paths["nnz"], nnz)
            for name in ("ids", "vals", "nnz"):
                os.remove(f"{stem}.{name}.npy")

        np.save(os.path.join(self.directory, "df.npy"),
                (df[perm] if remap else df).astype(np.int32))
        with open(os.path.join(self.directory, _META), "w") as f:
            json.dump({"format": STORE_FORMAT, "n_docs": self._n_docs,
                       "dim": self.dim, "chunk_size": c, "pad_width": p,
                       "n_chunks": self._n_raw}, f)
        return DocStore.open(self.directory)

    def abort(self):
        """Delete everything the builder wrote (crash clean-up)."""
        shutil.rmtree(self.directory, ignore_errors=True)


# ---------------------------------------------------------------------------
# Host -> device prefetch.
# ---------------------------------------------------------------------------

def _tensors(x):
    """The tensors of a prepare() result (a tensor or a flat container)."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for t in x if torch.is_tensor(t)]
    return []


_END, _ERR = object(), object()


class ChunkPrefetcher:
    """Store chunks on the device, read and copied ahead of the consumer.

    Iterating yields ``(chunk_index, SparseDocs)`` in ``order`` (default:
    every chunk in turn), each chunk with all its C rows.  ``iter()``
    starts the producer at once, so a caller can start the reads before
    it needs the first chunk.  On a CUDA ``device`` the chunks go through
    a ring of ``depth`` pinned host buffers: ``depth`` reader threads fill
    them (:meth:`DocStore.read_chunk`), and the producer thread issues each
    buffer's ``non_blocking`` copy to the device on a side stream and
    records one event per chunk; a buffer is refilled only after its
    copy's event has completed.  The consumer makes its current stream
    wait on the event and calls ``record_stream`` on the chunk's tensors,
    so the allocator does not hand them out again while its kernels still
    read them.  At most ``depth`` chunks wait in the queue.  On the CPU the
    producer yields host tensors and uses no stream.

    Producer exceptions re-raise at the consumer's next pull; a consumer
    that stops early (break, exception, or an iterator dropped unread)
    unblocks and joins the producer.  ``prepare`` — an optional
    ``(chunk_index, docs) -> extra`` run on the producer thread (on the
    side stream, before the event) — makes the iteration yield
    ``(chunk_index, docs, extra)`` triples.

    ``wait_s`` is the host seconds consumers spent blocked on the queue
    and ``late`` the chunks whose copy had not completed when taken: the
    copy time the prefetch did not hide from the host, and from the device.
    """

    def __init__(self, store: DocStore, *, depth: int = 2, order=None,
                 device="cuda", prepare=None):
        self.store = store
        self.depth = max(int(depth), 1)
        self.order = (list(range(store.n_chunks)) if order is None
                      else list(order))
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.prepare = prepare
        self.wait_s = 0.0
        self.late = 0

    def _read(self, ci: int, bufs: list, event) -> None:
        if event is not None:
            event.synchronize()         # the buffer's last copy is done
        self.store.read_chunk(ci, [b.numpy() for b in bufs])

    def _copy(self, bufs: list, side) -> SparseDocs:
        """The buffers' chunk, copied to the device on the side stream."""
        with torch.cuda.stream(side):
            dev = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                   for b in bufs]
            for d, b in zip(dev, bufs):
                d.copy_(b, non_blocking=True)
        return SparseDocs(dev[0], dev[1], dev[2], self.store.dim)

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        def put(item) -> bool:
            # Bounded-wait puts: an abandoned consumer cannot park this
            # thread on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        pool = None
        try:
            if self.device.type != "cuda" or not self.order:
                for ci in self.order:
                    if stop.is_set():
                        return
                    docs = _docs(*self.store.host_chunk(ci), self.store.dim,
                                 self.device)
                    extra = (None if self.prepare is None
                             else self.prepare(ci, docs))
                    if not put((ci, docs, extra, None)):
                        return
                put(_END)
                return
            torch.cuda.set_device(self.device)
            side = torch.cuda.Stream(self.device)
            c, p = self.store.chunk_size, self.store.pad_width
            ring = [[torch.empty(shape, dtype=dt, pin_memory=True)
                     for shape, dt in (((c, p), torch.int32),
                                       ((c, p), torch.float32),
                                       ((c,), torch.int32))]
                    for _ in range(min(self.depth, len(self.order)))]
            events = [None] * len(ring)
            pool = ThreadPoolExecutor(max_workers=len(ring))
            reads = {j: pool.submit(self._read, self.order[j], ring[j], None)
                     for j in range(len(ring))}
            for i, ci in enumerate(self.order):
                if stop.is_set():
                    return
                slot = i % len(ring)
                reads.pop(i).result()
                docs = self._copy(ring[slot], side)
                extra = None
                if self.prepare is not None:
                    with torch.cuda.stream(side):
                        extra = self.prepare(ci, docs)
                events[slot] = torch.cuda.Event()
                events[slot].record(side)
                nxt = i + len(ring)
                if nxt < len(self.order):
                    reads[nxt] = pool.submit(self._read, self.order[nxt],
                                             ring[slot], events[slot])
                if not put((ci, docs, extra, events[slot])):
                    return
            put(_END)
        except BaseException as e:          # re-raised at the consumer
            put((_ERR, e))
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self):
        return _Feed(self)


class _Feed:
    """One pass of a :class:`ChunkPrefetcher`: its producer runs from
    creation until the pass ends, fails or is dropped."""

    def __init__(self, pf: ChunkPrefetcher):
        self.pf = pf
        self.q: queue.Queue = queue.Queue(maxsize=pf.depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=pf._produce,
                                       args=(self.q, self.stop), daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self.stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self.q.get()
        self.pf.wait_s += time.perf_counter() - t0
        if item is _END:
            self.close()
            raise StopIteration
        if item[0] is _ERR:
            self.close()
            raise item[1]
        ci, docs, extra, event = item
        if event is not None:
            self.pf.late += not event.query()
            stream = torch.cuda.current_stream(self.pf.device)
            stream.wait_event(event)
            for x in (docs.ids, docs.vals, docs.nnz, *_tensors(extra)):
                x.record_stream(stream)
        return (ci, docs) if self.pf.prepare is None else (ci, docs, extra)

    def close(self) -> None:
        """Unblock and join the producer, then drop what it staged."""
        self.stop.set()
        self.thread.join()
        while not self.q.empty():
            self.q.get_nowait()

    def __del__(self):
        if getattr(self, "thread", None) is not None:
            self.close()
