"""Fault-tolerant checkpoint store: npz payload + JSON manifest
(counterpart of ``repro.checkpoint.store``, in numpy alone).

The on-disk format is ``repro``'s, so either package reads what the other
wrote:

  * a checkpoint is ``step_<n>/payload.npz`` (leaves ``leaf_0`` ...) +
    ``step_<n>/manifest.json`` (+ an optional ``extra.json`` sidecar);
  * writes go to ``step_<n>.tmp`` and commit by ``os.rename`` (atomic on
    POSIX): a crashed writer never leaves a readable-but-corrupt step;
  * ``keep`` retention prunes old steps only after a successful commit.

A tree is a dict of arrays (or of dicts of arrays).  Its leaves are
numbered in the order JAX flattens a dict, keys sorted, and the manifest's
``treedef`` is the string JAX prints for it (``PyTreeDef({'a': *, ...})``);
``repro``'s restore maps ``leaf_i`` by that order.  Torch tensors are
copied to the host on save; restore returns numpy arrays, which the caller
places on its device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):                # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree) -> tuple[list, str]:
    """(leaves, treedef string) of a dict tree, keys sorted as JAX does."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, sub_def = _flatten(tree[key])
            leaves += sub
            parts.append(f"{key!r}: {sub_def}")
        return leaves, "{" + ", ".join(parts) + "}"
    return [tree], "*"


def _unflatten(example, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(example)


def save_checkpoint(directory: str, tree, *, step: int, keep: int | None = 3,
                    extra: dict | None = None) -> str:
    """Atomically persist ``tree`` at ``step``; returns the committed path.

    ``keep=None`` disables retention pruning (artifact writers such as
    ``FittedModel.save``).  ``extra`` is a JSON sidecar committed in the
    same rename as the payload; read it back with :func:`load_extra`.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, treedef = _flatten(tree)
    leaves = [_host(x) for x in leaves]
    np.savez(os.path.join(tmp, "payload.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({treedef})",
        "n_leaves": len(leaves),
        "shapes": [list(np.shape(x)) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves],
        "format": 1,
    }
    if extra is not None:
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # commit point

    if keep is not None:
        for old in all_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                          ignore_errors=True)
    return final


def all_steps(directory: str) -> list[int]:
    """Committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _step_or_latest(directory: str, step: int | None) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def load_extra(directory: str, *, step: int | None = None) -> dict | None:
    """The JSON sidecar committed with ``step`` (None -> latest), or None
    if that checkpoint has none.  A missing step raises FileNotFoundError."""
    step = _step_or_latest(directory, step)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint step {step} under {directory}")
    path = os.path.join(step_dir, "extra.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_manifest(directory: str, *, step: int | None = None) -> dict:
    """The manifest of ``step`` (None -> latest): its leaves' shapes and
    dtypes, in the order of the tree's sorted keys."""
    step = _step_or_latest(directory, step)
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def restore_checkpoint(directory: str, example_tree, *,
                       step: int | None = None):
    """-> (tree of numpy arrays in ``example_tree``'s structure, step).
    Leaf count and shapes are checked against the example."""
    step = _step_or_latest(directory, step)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "payload.npz")) as payload:
        leaves = [payload[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    want, _ = _flatten(example_tree)
    if len(want) != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt {len(leaves)} vs "
                         f"example {len(want)}")
    for i, (got, w) in enumerate(zip(leaves, want)):
        if tuple(np.shape(got)) != tuple(np.shape(w)):
            raise ValueError(f"leaf {i} shape {np.shape(got)} != "
                             f"{np.shape(w)}")
    return _unflatten(example_tree, leaves), step


class AsyncCheckpointer:
    """One-in-flight async saver: the tree is copied to the host when
    ``save`` is called and written on a thread; the next ``save`` (or
    ``wait``) blocks until the previous write is done and re-raises its
    error."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree, *, step: int, extra: dict | None = None):
        self.wait()
        leaves, _ = _flatten(tree)
        host_tree = _unflatten(tree, [_host(x).copy() for x in leaves])
        extra = None if extra is None else dict(extra)

        def work():
            try:
                save_checkpoint(self.directory, host_tree, step=step,
                                keep=self.keep, extra=extra)
            except BaseException as e:    # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
