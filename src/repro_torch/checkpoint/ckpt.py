"""Checkpointing: npz snapshots with atomic rename, per-array checksums,
keep-last-k retention and async writes, in the JAX package's format.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json ; <dir>/LATEST.

The format is the JAX package's ``checkpoint/ckpt.py`` byte for byte: the
same flattened keys (dict keys sorted, list indices, joined by ``::``),
the same manifest (keys, shapes, dtypes, a crc32 per array), the same
``step_<N>`` directories and ``LATEST``. A checkpoint written by either
package restores in the other.

A tree is dicts, lists and tuples of leaves: torch tensors on any device,
numpy arrays or numpy scalars. numpy has no bfloat16 of its own, so a
bf16 leaf raises in ``save`` rather than being cast.

Fault-tolerance contract (tested in tests/test_torch_checkpoint.py and
tests/test_torch_resilience.py):
  * a checkpoint is visible only after its atomic rename -> a writer
    killed mid-write never corrupts the latest checkpoint;
  * ``manifest.json`` records a crc32 per array; ``restore`` verifies
    every array it reads and treats a mismatch (or an unreadable npz /
    manifest) as *corruption*, not a crash: the snapshot is quarantined
    (renamed ``corrupt_step_<N>``) and restore falls back to the newest
    remaining valid step.  Only an explicitly requested ``step=`` raises
    ``CheckpointCorruptError`` directly;
  * ``AsyncCheckpointer`` copies the tree to the host before ``save``
    returns (the train step updates its tensors in place), and never
    loses a writer error on its thread: the failure is counted
    (``ckpt_write_failures_total``) and warned about immediately, and
    re-raised from the next ``wait()``/``save()``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import warnings
import zlib

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed.sharding import shard_block, tree_map
from repro_torch.resilience import faults

SEP = "::"


class CheckpointCorruptError(RuntimeError):
    """A snapshot exists on disk but fails integrity verification
    (unreadable npz/manifest, or a per-array checksum mismatch)."""


def _checksum(arr: np.ndarray) -> str:
    # the crc32 of the array's C-order bytes, read in place
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return f"crc32:{zlib.crc32(flat):08x}"


def _walk(tree, prefix=()):
    """(key, leaf) pairs in JAX's flattening order: dict keys sorted, list
    and tuple items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield (SEP.join(prefix) if prefix else "_root"), tree


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _np_dtype(key: str, dtype) -> np.dtype:
    if dtype is torch.bfloat16 or getattr(dtype, "name", "") == "bfloat16":
        raise ValueError(
            f"checkpoint leaf {key!r} is bfloat16, which numpy cannot hold "
            f"without ml_dtypes; cast it explicitly before saving")
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _host(key: str, leaf, copy: bool) -> np.ndarray:
    """One leaf as a host numpy array (a copy that shares no memory with
    the leaf when ``copy``)."""
    if isinstance(leaf, torch.Tensor):
        _np_dtype(key, leaf.dtype)      # raises on bf16
        t = leaf.detach()
        if t.device.type == "cpu":
            return (t.clone() if copy else t).numpy()
        return t.cpu().numpy()          # a synchronous copy off the device
    arr = np.array(leaf) if copy else np.asarray(leaf)
    _np_dtype(key, arr.dtype)
    return arr


def _flatten(tree, copy: bool = False) -> dict:
    return {k: _host(k, leaf, copy) for k, leaf in _walk(tree)}


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint write; prunes old steps beyond ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    faults.fire("ckpt.write", step=step)
    arrays = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step,
                       "keys": sorted(arrays),
                       "shapes": {k: list(v.shape) for k, v in arrays.items()},
                       "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
                       "checksums": {k: _checksum(v)
                                     for k, v in arrays.items()}},
                      f)
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(ckpt_dir, ".latest_tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, ".latest_tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # quarantined snapshots are kept for post-mortems but bounded the same
    # way live steps are — only the newest ``keep`` survive
    bad = sorted(d for d in os.listdir(ckpt_dir)
                 if d.startswith("corrupt_step_"))
    for d in bad[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str):
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def all_steps(ckpt_dir: str) -> list:
    """Steps present on disk (not quarantined), ascending."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    out = []
    for d in names:
        if d.startswith("step_"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def _quarantine(ckpt_dir: str, step: int, reason: BaseException):
    """Move a corrupt snapshot out of the restore path (never delete it —
    a post-mortem may want the bytes)."""
    src = os.path.join(ckpt_dir, f"step_{step:010d}")
    dst = os.path.join(ckpt_dir, f"corrupt_step_{step:010d}")
    warnings.warn(f"checkpoint step {step} is corrupt ({reason}); "
                  f"quarantining to {dst}", stacklevel=3)
    obs.counter("ckpt_corrupt_total").inc()
    try:
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.rename(src, dst)
    except OSError:
        pass       # restore already skips it; quarantine is best-effort


def _restore_step(ckpt_dir: str, step: int, like, aliases, missing_ok,
                  verify: bool):
    """Restore one specific step; integrity failures raise
    ``CheckpointCorruptError``, structural mismatches with ``like``
    (missing key, shape mismatch) raise KeyError/ValueError."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
    except FileNotFoundError:
        raise
    except Exception as e:           # truncated zip, bad json, IO error
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable: {e!r}") from e
    checksums = manifest.get("checksums") if verify else None
    leaves = []
    with data:
        for key, leaf in _walk(like):
            disk_key = key if key in data.files else aliases.get(key)
            if disk_key is None or disk_key not in data.files:
                if key in missing_ok or key.split(SEP)[0] in missing_ok:
                    leaves.append(leaf)
                    continue
                raise KeyError(f"checkpoint {path} has no array for {key}")
            try:
                arr = data[disk_key]
            except Exception as e:   # zip CRC failure mid-member, short read
                raise CheckpointCorruptError(
                    f"checkpoint {path} array {disk_key!r} unreadable: "
                    f"{e!r}") from e
            if checksums is not None:
                # legacy manifests (pre-checksum) have no entry: accept as-is
                want = checksums.get(disk_key)
                if want is not None and _checksum(arr) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint {path} array {disk_key!r} fails its "
                        f"checksum ({_checksum(arr)} != {want})")
            if leaf is None:         # any shape: the leaf's layout is the
                leaves.append(arr)   # device's (a generator's state)
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
            leaves.append(arr.astype(_np_dtype(key, leaf.dtype), copy=False))
    return step, _rebuild(like, iter(leaves))


def restore(ckpt_dir: str, like, step: int | None = None, *,
            aliases: dict | None = None, missing_ok=(), verify: bool = True):
    """Restore into the structure of ``like`` (a tree whose leaves have
    ``shape`` and ``dtype``: tensors or numpy arrays); the restored leaves
    are host numpy arrays of the ``like`` leaves' dtypes.

    ``aliases`` maps a current flattened key to the legacy on-disk key that
    is read instead when the current key is absent (layout migrations, e.g.
    ``{"cache::written_step": "cache::age"}``). Keys listed in ``missing_ok``
    may be absent entirely; the corresponding ``like`` leaf is kept as-is.
    A ``None`` leaf in ``like`` takes the array on disk as it is, of any
    shape (``None`` when absent and listed in ``missing_ok``).

    With ``step=None`` the newest step that passes checksum verification
    wins: corrupt/truncated snapshots are quarantined and skipped, never
    restored.  An explicit ``step=`` raises ``CheckpointCorruptError``
    instead of falling back.  ``verify=False`` skips checksum checks (not
    file-level readability checks).

    Returns (step, tree). Raises FileNotFoundError when no (valid)
    checkpoint exists.
    """
    aliases = aliases or {}
    if step is not None:
        return _restore_step(ckpt_dir, step, like, aliases, missing_ok,
                             verify)
    candidates = all_steps(ckpt_dir)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    for s in reversed(candidates):
        try:
            return _restore_step(ckpt_dir, s, like, aliases, missing_ok,
                                 verify)
        except CheckpointCorruptError as e:
            _quarantine(ckpt_dir, s, e)
    raise FileNotFoundError(
        f"no valid checkpoint in {ckpt_dir}: all {len(candidates)} "
        f"snapshot(s) failed verification and were quarantined")


def restore_sharded(ckpt_dir: str, like, shardings, step: int | None = None,
                    *, aliases: dict | None = None, missing_ok=()):
    """Restore, then keep each rank's block: ``shardings`` matches ``like``
    with a ``Sharding(mesh, spec)`` (``distributed.sharding``) or None at
    each leaf, and ``like`` has the whole leaves' shapes (meta tensors do).
    The files are host arrays, the same whatever mesh wrote them, so this
    is the one conversion either way: a one-device checkpoint lands
    sharded on a mesh, and a mesh's lands on one device. Returns (step,
    tree of host arrays, each sharded one a copy of its block)."""
    step, tree = restore(ckpt_dir, like, step, aliases=aliases,
                         missing_ok=missing_ok)

    def place(s, arr):
        if s is None or not isinstance(arr, np.ndarray):
            return arr
        block = shard_block(arr, s.spec, s.mesh)
        return block.copy() if block is not arr else arr

    return step, tree_map(place, shardings, tree)


class AsyncCheckpointer:
    """Background-thread checkpoint writer: snapshot to host synchronously,
    serialize to disk asynchronously. One in-flight write at a time.

    ``save`` returns only once every leaf has been copied to host memory
    that no tensor shares, so a train step that updates the state in
    place right after it cannot change what is written.

    A writer failure is never silent: it is counted
    (``ckpt_write_failures_total``) and warned about on the worker thread
    the moment it happens, and additionally re-raised from the next
    ``wait()`` (or the implicit wait at the head of the next ``save``) so
    the training loop — or ``fit_supervised`` above it — sees the real
    exception type, not a vanished thread."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: BaseException | None = None
        self.failures = 0

    def save(self, step: int, tree):
        self.wait()
        host_tree = _flatten(tree, copy=True)        # snapshot now

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, keep=self.keep)
            except BaseException as e:     # re-raised on next wait()
                self.last_error = e
                self.failures += 1
                obs.counter("ckpt_write_failures_total").inc()
                warnings.warn(f"async checkpoint write for step {step} "
                              f"failed: {e!r}", stacklevel=2)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
