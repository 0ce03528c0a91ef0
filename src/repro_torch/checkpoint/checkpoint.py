"""Checkpoints of nested dicts and lists of tensors: a flattened-key npz
payload plus a JSON manifest (the port of
``src/repro/checkpoint/checkpoint.py``, same layout on disk).

A leaf's key joins its dict keys (sorted, as a JAX pytree orders them)
and list indices with ``"/"``; ``None`` holds no leaf.  The files are
``ckpt_%08d.npz`` and ``ckpt_%08d.json``; the manifest lists the keys and
a CRC32 of every array.  So the two packages read each other's
checkpoints of equal trees, and write equal keys and CRCs for equal
arrays.

What the port adds to the layout's rules:

* tensors go to the host before ``numpy()``; bfloat16 has no numpy type,
  so it is widened to float32 (lossless) and narrowed back to the
  template's dtype on restore, as the reference does for ``ml_dtypes``;
* a Python int leaf (the training state's ``epoch`` and ``step``) is
  written as a 0-d int32 array, as the reference's state holds them, and
  restored as an int;
* restored tensors land on the template's device.

Crash safety: the npz and the manifest are staged as temp files in the
checkpoint directory (each flushed and ``fsync``-ed), then published
with ``os.replace``, the manifest first.  A crash at any byte leaves temp
litter, a manifest without its npz, or an npz whose bytes miss the
manifest's CRCs: ``latest_step`` skips all three and ``verify_checkpoint``
raises :class:`CheckpointCorruptError` for them.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

Pytree = Any

_SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists on disk but fails validation: unreadable
    manifest, missing or unloadable npz, key sets that disagree, or a CRC32
    that does not match the bytes on disk.  Distinct from
    ``FileNotFoundError`` (no checkpoint) and from the ``KeyError`` /
    ``ValueError`` a valid checkpoint raises against a template it does
    not fit."""


def _paths(tree: Pytree, prefix: tuple = ()) -> list:
    """``[(key, leaf)]`` in the reference's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten_with_paths(tree: Pytree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _from_numpy(arr: np.ndarray, leaf):
    """``arr`` in the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=leaf.dtype,
                                                  device=leaf.device)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _rebuild(template: Pytree, leaves) -> Pytree:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _npz_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")


def _manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    meta: Optional[dict] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``ckpt_dir``; returns the
    npz's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten_with_paths(tree)
    manifest = {"step": int(step), "keys": sorted(flat),
                "checksums": {k: _crc32(v) for k, v in flat.items()}}
    if meta:
        manifest["meta"] = meta
    path = _npz_path(ckpt_dir, step)
    fd, tmp_npz = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    fd, tmp_json = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    try:
        # Stage both files before publishing either.  The manifest is the
        # commit record (it carries the CRCs the npz must match), so it is
        # replaced into place first: a crash between the two replaces
        # leaves a manifest without its payload, which validation rejects.
        with open(tmp_npz, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp_json, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_json, _manifest_path(ckpt_dir, step))
        os.replace(tmp_npz, path)
    finally:
        for tmp in (tmp_npz, tmp_json):
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """Load a step's manifest; malformed JSON → CheckpointCorruptError."""
    path = _manifest_path(ckpt_dir, step)
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"manifest {path} is not valid JSON: {e}") from e


def verify_checkpoint(ckpt_dir: str, step: int) -> dict:
    """Validate the manifest and npz of ``step``; return the manifest.

    Raises ``FileNotFoundError`` if the manifest is absent and
    :class:`CheckpointCorruptError` if the npz is missing or unloadable,
    its keys disagree with the manifest's, or a CRC32 does not match.  A
    manifest without ``"checksums"`` passes the key check only.
    """
    manifest = read_manifest(ckpt_dir, step)
    path = _npz_path(ckpt_dir, step)
    try:
        with np.load(path) as data:
            keys = set(data.files)
            arrays = {k: data[k] for k in keys}
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"manifest for step {step} present but payload {path} "
            f"missing") from e
    except Exception as e:  # zipfile/pickle errors from a torn write
        raise CheckpointCorruptError(
            f"payload {path} unreadable: {e}") from e
    want = set(manifest.get("keys", []))
    if want and keys != want:
        raise CheckpointCorruptError(
            f"payload {path} key set disagrees with manifest "
            f"(missing {sorted(want - keys)[:4]}, "
            f"extra {sorted(keys - want)[:4]})")
    for key, crc in (manifest.get("checksums") or {}).items():
        if key not in arrays:
            raise CheckpointCorruptError(
                f"payload {path} missing checksummed key {key!r}")
        if _crc32(arrays[key]) != int(crc):
            raise CheckpointCorruptError(
                f"CRC32 mismatch for {key!r} in {path}")
    return manifest


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose checkpoint validates (``verify_checkpoint``):
    partial or corrupt checkpoints are skipped, so a crash mid-save falls
    back to the newest one that can be restored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = {int(m.group(1))
             for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"ckpt_(\d+)\.(?:npz|json)", name))}
    for step in sorted(steps, reverse=True):
        try:
            verify_checkpoint(ckpt_dir, step)
        except (FileNotFoundError, CheckpointCorruptError):
            continue
        return step
    return None


def restore_checkpoint(ckpt_dir: str, template: Pytree,
                       step: Optional[int] = None,
                       sharding: Optional[Any] = None
                       ) -> tuple[Pytree, int]:
    """``(tree, step)``: checkpoint ``step`` (default the newest valid
    one) in the structure, dtypes and devices of ``template``.  Raises
    ``FileNotFoundError`` when there is none, ``KeyError`` for a key the
    checkpoint lacks and ``ValueError`` for a shape that differs.

    A checkpoint holds whole arrays, so ``template`` is the whole tree;
    ``sharding`` (the reference's ``jax.device_put`` placement) is a
    callable that takes the restored whole tree to this rank's part, e.g.
    ``lambda t: repro_torch.core.digest.shard_state(t, mesh)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {ckpt_dir}")
    verify_checkpoint(ckpt_dir, step)
    leaves = []
    with np.load(_npz_path(ckpt_dir, step)) as data:
        for key, leaf in _paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            arr = data[key]
            want = tuple(np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                         else leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                    f"template {want}")
            leaves.append(_from_numpy(arr, leaf))
    tree = _rebuild(template, iter(leaves))
    if sharding is not None:
        tree = sharding(tree)
    return tree, int(step)
