"""Checkpoints of tensor trees without external dependencies, in the
reference's on-disk format (``repro.checkpoint.store``).

Layout: ``<dir>/step_<N>/arrays.npz`` and ``manifest.json``.  The manifest
holds ``step``, ``leaves`` (each key's npz name, dtype and shape), ``digest``
(the SHA-256 of ``arrays.npz``) and ``extra``.  A tree is nested dicts,
lists and tuples of tensors, Python ints and ``None`` holes; a leaf's key is
its path, joined by ``/``.  A Python int is stored as a 0-dim int64 array
and comes back as an int; a hole stores nothing and comes back a hole.
bfloat16 has no numpy dtype and is stored through a ``uint16`` view, with
``"bfloat16"`` in the manifest, as in the reference.

``save_train_state`` / ``restore_train_state`` round-trip the trainer's
state (``params``, ``opt``, ``comp`` and ``step``).  The compressor state,
the EF residual, is the gradient mass the filter has deferred: a restart
that drops it silently loses the paper's accuracy guarantee.  ``names``
(the model's leaf paths, ``Trainer.leaf_names``) keys each per-leaf list
by name, ``opt/m/stack.blocks.w_qkv`` for example, so that a checkpoint
read into another leaf set fails loudly.  The manifest's ``extra`` records
the interval the residual was accumulated under, so that a restart into
another interval goes through ``runtime.transitions``, and the world size.

**Several workers.**  Each worker's residual is its own (an unselected
bucket keeps ``r' = t_local``), so with a process group every rank's
compressor state is saved: rank 0 writes the params, the optimizer state
(the same on every rank after ``Trainer.flush_sync``) and its own comp
state into ``arrays.npz``, each other rank writes its comp state into
``comp_rank<r>.npz`` of the same staging directory, and the manifest lists
each rank file with its digest.  Only rank 0 publishes, and every rank
waits at a barrier after the publish, so no rank reads a step directory
before it is whole.  A restore reads each rank's own comp state; at
another world size the comp state stays fresh (``comp_restored=False``,
with a warning), as when its structure drifted.  With one worker the files
are the reference's.

Crash safety: ``save`` writes into a dot-prefixed sibling directory (which
``latest_step``'s ``step_(\\d+)`` scan skips) and publishes it with one
``os.replace``, so a crash mid-save leaves the previous checkpoint or a
stray temp directory, never a readable but partial ``step_<N>``.
``restore`` verifies every payload's digest first and raises
:class:`CheckpointCorruptError` (deliberately not a ``ValueError``, so that
``restore_train_state``'s comp-structure fallback cannot swallow at-rest
corruption) on a mismatch, a truncation or a missing payload.

``restore`` writes the checkpoint's values into the ``like`` tree's
tensors in place, on their devices: the caller's tree alone chooses the
device, and a train state's ``params`` stay the model's parameters.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
from typing import Any, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

ARRAYS = "arrays.npz"
MANIFEST = "manifest.json"



class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk fails its integrity checks (digest mismatch,
    truncated or missing payload).  Restoring it would deserialize garbage
    into live training state: treat the checkpoint as lost, do not
    retry."""


def _digest_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _is_leaf(x: Any) -> bool:
    return isinstance(x, torch.Tensor) or (isinstance(x, int) and not isinstance(x, bool))


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(key, leaf)`` of every tensor and int in ``tree``, in tree order;
    ``None`` holes are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif _is_leaf(tree):
        yield prefix[:-1], tree
    elif tree is not None:
        raise TypeError(f"checkpoint: cannot store {type(tree).__name__} at "
                        f"{prefix[:-1]!r}")


def _host_array(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64), "int64"
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), str(t.dtype).removeprefix("torch.")


def _write_payload(path: str, tree: Any) -> tuple[dict, str]:
    """Write every leaf of ``tree`` into the npz at ``path`` -> ``(leaves
    manifest, digest)``; npz names ``a<i>`` follow the sorted keys, as in
    the reference."""
    arrays, manifest = {}, {}
    for i, (key, leaf) in enumerate(sorted(_leaves(tree), key=lambda kv: kv[0])):
        arr, dtype = _host_array(leaf)
        name = f"a{i}"
        arrays[name] = arr
        manifest[key] = {"name": name, "dtype": dtype, "shape": list(arr.shape)}
    np.savez(path, **arrays)
    return manifest, _digest_file(path)


def _tmp_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f".tmp_step_{step:08d}")


def _begin(directory: str, step: int) -> tuple[str, str]:
    """The step directory and its dot-prefixed staging sibling, emptied."""
    tmp = _tmp_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return _step_dir(directory, step), tmp


def _publish(tmp: str, d: str, step: int, leaves: dict, digest: str, extra: dict,
             ranks: dict | None = None) -> None:
    manifest = {"step": step, "leaves": leaves, "digest": digest,
                "extra": dict(extra or {})}
    if ranks:
        manifest["ranks"] = ranks
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    # os.replace needs the target gone (a non-empty directory is not
    # replaced): removing a whole old copy first keeps step_<N> either
    # absent or whole
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)


def save(directory: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``directory`` (one writer)
    and return its directory."""
    d, tmp = _begin(directory, step)
    leaves, digest = _write_payload(os.path.join(tmp, ARRAYS), tree)
    _publish(tmp, d, step, leaves, digest, extra)
    return d


def _read_manifest(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), MANIFEST)) as f:
        return json.load(f)


def load_extra(directory: str, step: int) -> dict:
    """The ``extra`` metadata dict stored alongside a checkpoint."""
    return _read_manifest(directory, step).get("extra", {})


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for m in (re.match(r"step_(\d+)$", n) for n in os.listdir(directory))
        if m
    ]
    return max(steps) if steps else None


def _check_payload(d: str, name: str, recorded: str | None) -> None:
    path = os.path.join(d, name)
    if not os.path.exists(path):
        raise CheckpointCorruptError(
            f"checkpoint {d} has a manifest but no {name}: a partial write or "
            f"a deleted payload; treat this checkpoint as lost")
    if recorded is None:
        return
    actual = _digest_file(path)
    if actual != recorded:
        raise CheckpointCorruptError(
            f"checkpoint {d} is corrupted: {name} digest {actual} does not "
            f"match the manifest's {recorded}; refusing to deserialize")


def verify(directory: str, step: int) -> str | None:
    """Check every payload of one checkpoint against the digests in its
    manifest (``arrays.npz``, and each rank's comp file).  Returns the
    digest of ``arrays.npz`` (``None`` for a checkpoint without digests,
    which carries nothing to verify); raises
    :class:`CheckpointCorruptError` on a mismatch or a missing payload."""
    d = _step_dir(directory, step)
    manifest = _read_manifest(directory, step)
    recorded = manifest.get("digest")
    _check_payload(d, ARRAYS, recorded)
    for entry in manifest.get("ranks", {}).values():
        _check_payload(d, entry["file"], entry.get("digest"))
    return recorded


def _fill(like: Any, leaves: dict, path: str, prefix: str = "") -> Any:
    """Check ``like`` against a payload's manifest and fill it: every
    tensor of ``like`` gets the stored values in place, every int the
    stored int; returns ``like``'s structure.  Nothing is written until
    every leaf has been checked, so a ``KeyError`` (a missing leaf) or a
    ``ValueError`` (another shape or dtype) leaves ``like`` untouched."""
    pairs = []
    with np.load(path) as data:
        for key, leaf in _leaves(like, prefix):
            if key not in leaves:
                raise KeyError(f"checkpoint missing leaf {key}")
            meta = leaves[key]
            arr = data[meta["name"]]
            shape = () if isinstance(leaf, int) else tuple(leaf.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                                 f"model {shape}")
            if isinstance(leaf, int):
                pairs.append((key, int(arr)))
                continue
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if t.dtype != leaf.dtype:
                raise ValueError(f"dtype mismatch for {key}: ckpt {t.dtype} vs "
                                 f"model {leaf.dtype}")
            pairs.append((key, t))
    values = dict(pairs)
    with torch.no_grad():
        for key, leaf in _leaves(like, prefix):
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(values[key])
    return _rebuild(like, values, prefix)


def _rebuild(like: Any, values: dict, prefix: str) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, f"{prefix}{i}/") for i, v in enumerate(like))
    if isinstance(like, int) and not isinstance(like, bool):
        return values[prefix[:-1]]
    return like


def restore(directory: str, step: int, like: Any) -> Any:
    """Verify checkpoint ``step`` and read ``arrays.npz`` into ``like``'s
    tensors in place (see :func:`_fill`); returns ``like``'s structure with
    ints restored."""
    verify(directory, step)
    d = _step_dir(directory, step)
    return _fill(like, _read_manifest(directory, step)["leaves"], os.path.join(d, ARRAYS))


# ---------------------------------------------------------------------------
# the train state (params + opt + compressor/EF state + step)
# ---------------------------------------------------------------------------

_STATE_KEYS = ("params", "opt", "comp", "step")


def _by_name(tree: Any, names: Sequence[str] | None) -> Any:
    """Every per-leaf list in ``tree`` (as long as ``names``) as a dict by
    leaf name."""
    if names is None:
        return tree
    if isinstance(tree, dict):
        return {k: _by_name(v, names) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree and len(tree) == len(names):
        return dict(zip(names, tree))
    return tree


def _by_index(tree: Any, like: Any, names: Sequence[str] | None) -> Any:
    """The inverse of :func:`_by_name`, shaped as ``like``."""
    if names is None:
        return tree
    if isinstance(like, dict):
        return {k: _by_index(tree[k], v, names) for k, v in like.items()}
    if isinstance(like, (list, tuple)) and like and len(like) == len(names):
        return type(like)(tree[n] for n in names)
    return tree


def _has_tensors(tree: Any) -> bool:
    return any(isinstance(x, torch.Tensor) for _, x in _leaves(tree))


def _rank_file(rank: int) -> str:
    return f"comp_rank{rank:05d}.npz"


def _ranks(group) -> tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def save_train_state(
    directory: str, state: dict, *, interval: int | None = None,
    extra: dict | None = None, names: Sequence[str] | None = None, group=None,
    shared: bool = True,
) -> str:
    """Persist a trainer state (``params``/``opt``/``comp``/``step``).

    ``interval`` (and anything in ``extra``) lands in the manifest's
    ``extra``, with ``has_comp_state`` and ``world``.  ``names`` are the
    model's leaf paths (``Trainer.leaf_names``; without them a leaf's key
    is its index).  With a ``group`` of several ranks every rank calls
    this, after ``Trainer.flush_sync`` (``Trainer.run`` ends with it), and
    each rank's comp state is saved; only rank 0 publishes, and every rank
    returns after the publish.  ``shared=False`` (hierarchical pods, whose
    params and moments differ between pods) has every rank save its whole
    state, and marks the manifest ``per_rank``."""
    meta = dict(extra or {})
    if interval is not None:
        meta["interval"] = int(interval)
    meta["has_comp_state"] = _has_tensors(state.get("comp", ()))
    W, rank = _ranks(group)
    meta["world"] = W
    if not shared and W > 1:
        meta["per_rank"] = True
    tree = {k: _by_name(state[k], names) for k in _STATE_KEYS if k in state}
    step = int(state["step"])
    if W == 1:
        return save(directory, step, tree, extra=meta)
    d, tmp = _step_dir(directory, step), _tmp_dir(directory, step)
    if rank == 0:
        _begin(directory, step)
    dist.barrier(group=group)
    if rank == 0:
        written = _write_payload(os.path.join(tmp, ARRAYS), tree)
    else:
        written = _write_payload(os.path.join(tmp, _rank_file(rank)),
                                 tree if meta.get("per_rank")
                                 else {"comp": tree.get("comp", ())})
    every = [None] * W
    dist.all_gather_object(every, written, group=group)
    if rank == 0:
        ranks = {str(r): {"file": _rank_file(r), "digest": digest, "leaves": leaves}
                 for r, (leaves, digest) in enumerate(every) if r}
        leaves, digest = every[0]
        _publish(tmp, d, step, leaves, digest, meta, ranks)
    dist.barrier(group=group)
    return d


def restore_train_state(
    directory: str, like_state: dict, *, step: int | None = None,
    names: Sequence[str] | None = None, group=None,
) -> tuple[dict, dict]:
    """Restore a trainer state saved by :func:`save_train_state` into
    ``like_state``, a fresh ``Trainer.init_state()`` that gives the
    structure, the shapes and the devices (its tensors are filled in
    place; the compressor state too, so EF residuals come back as their
    values, not zeros).  Returns ``(state, extra)``; ``extra`` carries the
    saved interval, so that a caller can re-plan when the restart's config
    drifted.  ``names`` must be those the checkpoint was saved with.

    The compressor state is restored leaf-compatibly: when the saved and
    current structures differ (EF on one side of an ``I = 1`` restart only,
    another state family), or the checkpoint was saved at another world
    size, params and opt still restore and the comp state keeps its fresh
    initialisation, with ``extra["comp_restored"] = False`` so that callers
    can warn about the dropped residual.  With a group each rank reads its
    own comp state, and its whole state from a ``per_rank`` checkpoint
    (``save_train_state(shared=False)``), which restores only at the world
    size it was saved at."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    verify(directory, step)
    manifest = _read_manifest(directory, step)
    extra = dict(manifest.get("extra", {}))
    d = _step_dir(directory, step)
    like = {k: _by_name(like_state[k], names) for k in _STATE_KEYS if k in like_state}
    shared = {k: v for k, v in like.items() if k != "comp"}
    W, rank = _ranks(group)
    own_leaves, own_path = manifest["leaves"], os.path.join(d, ARRAYS)
    if rank and str(rank) in manifest.get("ranks", {}):
        entry = manifest["ranks"][str(rank)]
        own_leaves, own_path = entry["leaves"], os.path.join(d, entry["file"])
    if extra.get("per_rank"):
        if int(extra.get("world", 1)) != W:
            raise ValueError(
                f"checkpoint {d} holds a per-rank state of {extra.get('world')} "
                f"ranks; this run has {W}")
        tree = _fill(shared, own_leaves, own_path)
    else:
        tree = _fill(shared, manifest["leaves"], os.path.join(d, ARRAYS))
    comp_restored = True
    if "comp" in like:
        saved_world = int(extra.get("world", 1))
        like_has = _has_tensors(like["comp"])
        if saved_world != W:
            comp_restored = not like_has
            if like_has:
                warnings.warn(
                    f"checkpoint {d} holds the compressor state of {saved_world} "
                    f"worker(s), this run has {W}: the EF residuals start from "
                    f"zero", RuntimeWarning, stacklevel=2)
        else:
            try:
                tree["comp"] = _fill(like["comp"], own_leaves, own_path, "comp/")
                # a saved residual read into a like state with no comp
                # leaves succeeds trivially: the save-time marker catches
                # that direction
                comp_restored = like_has == bool(extra.get("has_comp_state", like_has))
            except (KeyError, ValueError):
                # the comp structure drifted (EF on/off, another state
                # family): it stays fresh
                comp_restored = False
    state = dict(like_state)
    state.update({k: _by_index(v, like_state[k], names) for k, v in tree.items()})
    state["step"] = int(step)
    extra["comp_restored"] = comp_restored or "comp" not in like_state
    return state, extra
