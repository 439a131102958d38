"""Checkpoint / resume with verified atomic saves.

The port of the single-process path of
``flexflow_tpu/runtime/checkpoint.py``: the full training state (params,
optimizer state, op state, step) is saved and restored with the same
durability contract and in the same files, so a step written by either
package restores into the other:

  - **atomic**: each step is written into a ``tmp-<step>`` staging dir
    (state payload, then ``manifest.json``, then ``meta.json``, each
    fsynced) and published with one ``os.replace`` rename — a crash at
    any point leaves either the previous complete step or an ignored
    staging dir, never a half-step that lists as valid;
  - **verified**: ``manifest.json`` records every state leaf's shape,
    dtype and CRC32, keyed by the JAX package's ``keystr`` path
    (``"['params']['layer']['kernel']"``); restore re-hashes the loaded
    leaves and refuses a silently-corrupted step
    (:class:`CheckpointCorruption`);
  - **self-healing restore**: ``restore()`` with no explicit step walks
    steps newest-first and falls back past corrupt/partial ones (with a
    warning and a counter) to the newest valid step;
  - **async-capable**: ``save(..., blocking=False)`` copies every leaf
    to the host in the caller and writes the files on a background
    thread. The copy must finish before ``save`` returns: the port's
    optimizers (the fused Adam above all) overwrite weights and moments
    IN PLACE, where the JAX package's arrays are immutable, so a step
    run right after the save would otherwise leak into the saved step.

The payload is always the JAX package's numpy writer's: ``state.pkl``, a
pickle of nested dicts of numpy arrays with ``{"params", "opt_state",
"state"}`` at the top. orbax is JAX-only: a step that orbax wrote (a
``state/`` directory) raises :class:`UnsupportedCheckpointFormat`.

A world of ranks (``torch.distributed``, more than one rank) writes the
JAX package's multi-host format (v2, ``manifest.json`` carries
``"format": "multihost"``) with its **two-phase commit**:

  1. **stage**: every rank pickles ONLY the blocks it owns (no
     collective gather — each DTensor leaf's distinct block is written
     by the lowest rank that holds it, a replicated leaf or a plain
     tensor once, by rank 0) into ``tmp-<step>/shard-<rank>.pkl`` + an
     fsynced ``shard-<rank>.ok.json`` sidecar recording the file's CRC32;
  2. **barrier** (bounded, through the coordinator's store,
     ``resilience/coord.py`` — a dead rank raises
     :class:`~flexflow_tpu_torch.resilience.coord.RankFailure` instead of
     hanging the save);
  3. **commit**: rank 0 alone writes ``manifest.json`` naming every
     shard file + CRC, then ``meta.json``, then publishes the step with
     one atomic rename. A crash at ANY point leaves either a
     fully-restorable committed step or ignored ``tmp-*`` debris.

Restore in a world reaches **quorum**: each rank publishes the steps it
verifies (manifest + every shard CRC) to the coordinator's store, and
all ranks adopt the newest step EVERY rank verified. A world of any size
restores the same files: every rank assembles the full host state from
all shard files and copies its own block of each leaf into the live
tensors, so a step saved by two ranks restores onto one and one saved
by one restores onto two. A shard holds :class:`ShardBlocks` leaves,
which the port pickles under the JAX package's class path
(``flexflow_tpu.runtime.checkpoint.ShardBlocks``, resolved by the reader
through ``importlib``, so writing it imports nothing of that package)
and which :class:`_Unpickler` maps back to the port's own class: a step
crosses packages both ways. numpy has no bfloat16 of its own and
the port does not depend on ``ml_dtypes``, so it handles a bf16 leaf
as its raw two-byte payload (a ``uint16`` array) under the manifest dtype
``"bfloat16"``, whose CRC32 is that of the same bytes, and crosses both
ways without ``ml_dtypes``:

  - it pickles the leaf as ``numpy.ndarray(shape, numpy.dtype("bfloat16"),
    payload)`` (:class:`_BF16Leaf`). Where ``ml_dtypes`` is loaded, as it
    always is in the JAX package, numpy resolves that dtype by name, so
    the JAX package unpickles a writable ``ml_dtypes`` bfloat16 array over
    the same bytes and its manifest check (``str(dtype)`` and CRC32)
    holds;
  - it reads through :class:`_Unpickler`, which resolves a bfloat16 dtype,
    by that name or as ``ml_dtypes.bfloat16`` (how an ``ml_dtypes`` array,
    the JAX package's form, pickles its dtype), to ``uint16``: either form
    loads as the payload, which restore copies into a bf16 tensor.

f32 leaves pickle as plain numpy arrays, as before.

Restore writes into the live tensors with ``copy_`` (same device, dtype
and strides): no second copy of the state on the device, and the fused
Adam's pointer table, cached by ``data_ptr``, stays valid.
"""
from __future__ import annotations

import importlib
import json
import logging
import os
import pickle
import shutil
import threading
import time
import types
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY

log = logging.getLogger("flexflow_tpu_torch")

#: manifest dtype of a bfloat16 leaf (handled as its uint16 payload)
BF16 = "bfloat16"


class _BF16DType:
    """Pickles as ``numpy.dtype("bfloat16")``: through the ``numpy.dtype``
    global, which :class:`_Unpickler` resolves (``numpy.ndarray``, which
    every protocol-4 numpy pickle also names, it leaves alone)."""

    def __reduce__(self):
        return np.dtype, (BF16,)


class _BF16Leaf:
    """A bf16 leaf's uint16 payload as the port pickles it:
    ``numpy.ndarray(shape, numpy.dtype("bfloat16"), payload)``, the
    payload in-band as a bytearray (protocol 5 writes a writable buffer
    so), so the array unpickles writable."""

    __slots__ = ("payload",)

    def __init__(self, payload: np.ndarray):
        self.payload = payload

    def __reduce__(self):
        return np.ndarray, (self.payload.shape, _BF16DType(),
                            pickle.PickleBuffer(self.payload))


class _MLDtypesBF16:
    """Stands for ``ml_dtypes.bfloat16`` while the port unpickles."""


def _numpy_dtype(spec, *args):
    """``numpy.dtype`` as the port's reader resolves it: bfloat16, by
    name or as ``ml_dtypes.bfloat16``, is a fresh uint16 descriptor (the
    pickle's state for ml_dtypes' dtype then sets its byte order, size
    and alignment, which uint16 shares)."""
    if spec is _MLDtypesBF16 or (isinstance(spec, str) and spec == BF16):
        return np.dtype(np.uint16, False, True)
    return np.dtype(spec, *args)


#: where the JAX package keeps the class of a multi-host shard leaf
_JAX_CKPT = "flexflow_tpu.runtime.checkpoint"


class ShardBlocks:
    """One leaf of the multi-host shard tree: the global array metadata
    plus the blocks THIS rank owns. Blocks are ``(index, ndarray)``
    where ``index`` is a per-dim ``[start, stop]`` list into the global
    shape (a bf16 block is its uint16 payload, under dtype
    "bfloat16"). Pickles as the JAX package's class of the same name
    and state (see :class:`_Ref`)."""

    __slots__ = ("shape", "dtype", "blocks")

    def __init__(self, shape, dtype, blocks):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = str(dtype)
        self.blocks = blocks

    def __getstate__(self):
        return (self.shape, self.dtype, self.blocks)

    def __setstate__(self, s):
        self.shape, self.dtype, self.blocks = s

    def __reduce__(self):
        blocks = [(idx, _BF16Leaf(a) if self.dtype == BF16 else a)
                  for idx, a in self.blocks]
        return _Ref(_JAX_CKPT, "ShardBlocks"), (self.shape, self.dtype,
                                                 blocks)


class _Module:
    """Pickles as ``importlib.import_module(name)``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _Ref:
    """Pickles as ``getattr(importlib.import_module(module), name)``: a
    class the READER resolves by its path, without the writer importing
    it (the JAX package's reader imports its own checkpoint module; the
    port's :class:`_Unpickler` answers with the port's class)."""

    __slots__ = ("module", "name")

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __reduce__(self):
        return getattr, (_Module(self.module), self.name)

    def __call__(self, *args):
        # a reduce value's callable; only the reader ever calls the
        # class it stands for
        raise TypeError(f"{self.module}.{self.name} is resolved when a "
                        f"checkpoint is read")


def _import_for_port(name: str):
    """``importlib.import_module`` as the port's reader resolves it: the
    JAX package's checkpoint module is the port's shard class, and no
    other module may be imported by a checkpoint."""
    if name != _JAX_CKPT:
        raise pickle.UnpicklingError(
            f"a checkpoint may not import {name!r}")
    return types.SimpleNamespace(ShardBlocks=ShardBlocks)


class _Unpickler(pickle.Unpickler):
    """Loads ``state.pkl`` and shard files without ``ml_dtypes``: a bf16
    leaf of either package's form arrives as its uint16 payload, and a
    shard leaf of either package's form as the port's
    :class:`ShardBlocks`."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes" and name == BF16:
            return _MLDtypesBF16
        if (module, name) == ("numpy", "dtype"):
            return _numpy_dtype
        if (module, name) == (_JAX_CKPT, "ShardBlocks"):
            return ShardBlocks
        if (module, name) == ("importlib", "import_module"):
            return _import_for_port
        return super().find_class(module, name)


class CheckpointCorruption(RuntimeError):
    """A checkpoint step failed integrity verification on restore."""


class UnsupportedCheckpointFormat(ValueError):
    """A step in a format the port does not read: orbax's ``state/``
    directory. Not corruption: the restore walk raises it rather than
    falling back past a valid step."""


def _keystr(path: Tuple) -> str:
    """A leaf's key path as ``jax.tree_util.keystr`` spells a path of
    dict keys: ``['params']['layer']['kernel']``."""
    return "".join(f"[{k!r}]" for k in path)


def _walk(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of nested dicts in the JAX package's flattening
    order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _map(tree, fn, path: Tuple = ()):
    """The nested dicts with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _host_leaf(x) -> Tuple[np.ndarray, bool]:
    """A finished host copy of one leaf as numpy, and whether it is a
    bf16 payload. Tensors are always copied (a CPU tensor's numpy view
    would alias the live leaf that the next step updates in place)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        arr = t.to("cpu", copy=True).contiguous().numpy()
        return (arr.view(np.uint16) if bf16 else arr), bf16
    arr = np.asarray(x)
    return arr, str(arr.dtype) == BF16


def _tree_to_host(tree) -> Tuple[Any, Set[str]]:
    """The state as nested dicts of host numpy arrays, and the keystr
    paths of its bf16 leaves."""
    bf16: Set[str] = set()

    def fetch(path, x):
        arr, is_bf16 = _host_leaf(x)
        if is_bf16:
            bf16.add(_keystr(path))
        return arr

    return _map(tree, fetch), bf16


def _flat_leaves(tree) -> List[Tuple[str, np.ndarray]]:
    """(key-path, numpy leaf) pairs in deterministic tree order."""
    return [(_keystr(p), np.asarray(x)) for p, x in _walk(tree)]


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes without materializing a copy: crc32
    reads the contiguous array buffer directly (this runs on every save
    AND restore). Exotic dtypes the buffer protocol refuses (e.g.
    ml_dtypes bf16) fall back to tobytes()."""
    a = np.ascontiguousarray(arr)
    try:
        buf = a.data
    except (ValueError, BufferError):
        buf = a.tobytes()
    return zlib.crc32(buf) & 0xFFFFFFFF


def _manifest_of(host_state, bf16: Set[str] = frozenset()
                 ) -> Dict[str, Any]:
    """Per-leaf integrity manifest: shape/dtype/CRC32 of the raw bytes."""
    leaves = {}
    for key, arr in _flat_leaves(host_state):
        leaves[key] = {
            "shape": list(arr.shape),
            "dtype": BF16 if key in bf16 else str(arr.dtype),
            "crc32": _crc32(arr),
        }
    return {"version": 1, "leaves": leaves}


def _dtype_matches(arr: np.ndarray, want: str) -> bool:
    # the port loads a bf16 leaf as its uint16 payload, whichever package
    # wrote it
    return str(arr.dtype) == want or (want == BF16
                                      and arr.dtype == np.uint16)


def _verify_manifest(state, manifest: Dict[str, Any], where: str) -> None:
    """Raise :class:`CheckpointCorruption` on any leaf mismatch."""
    want = manifest.get("leaves", {})
    got = dict(_flat_leaves(state))
    if set(want) != set(got):
        missing = sorted(set(want) - set(got))[:4]
        extra = sorted(set(got) - set(want))[:4]
        raise CheckpointCorruption(
            f"{where}: leaf set mismatch (missing={missing}, "
            f"unexpected={extra})")
    for key, rec in want.items():
        arr = got[key]
        if list(arr.shape) != list(rec["shape"]) \
                or not _dtype_matches(arr, rec["dtype"]):
            raise CheckpointCorruption(
                f"{where}: leaf {key} is {arr.dtype}{list(arr.shape)}, "
                f"manifest says {rec['dtype']}{rec['shape']}")
        crc = _crc32(arr)
        if crc != rec["crc32"]:
            raise CheckpointCorruption(
                f"{where}: leaf {key} CRC32 {crc:#010x} != manifest "
                f"{rec['crc32']:#010x} (bit rot or truncated write)")


def _np_dtype(t: torch.Tensor) -> str:
    """The numpy dtype name of a tensor's host copy ("bfloat16" for
    bf16, held as its uint16 payload)."""
    if t.dtype == torch.bfloat16:
        return BF16
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _norm_index(idx, shape) -> List[List[int]]:
    """A shard's index tuple as concrete [start, stop] per dim."""
    out = []
    for r, dim in zip(idx, shape):
        if isinstance(r, slice):
            out.append([int(r.start or 0),
                        int(dim if r.stop is None else r.stop)])
        else:
            out.append([int(r), int(r) + 1])
    # dims beyond the index tuple are unsharded
    out.extend([0, int(dim)] for dim in shape[len(idx):])
    return out


def _owned_blocks(x) -> ShardBlocks:
    """The blocks of leaf ``x`` this rank must persist. Each distinct
    block of a DTensor is owned by the lowest rank that holds it
    (``parallel/distributed.block_owner``: the ranks that differ only
    along mesh dims the leaf is not sharded over hold the same block),
    so a replicated leaf is written once, by rank 0, a sharded leaf
    exactly partitions across the world, and no byte is written twice.
    A plain tensor or array is written whole by rank 0. Owned blocks
    are copied to the host here (the optimizers update in place)."""
    from ..parallel.distributed import (block_owner, process_index,
                                        shard_bounds)
    from ..parallel.local_ops import is_dtensor
    me = process_index()
    if is_dtensor(x):
        mesh, pl = x.device_mesh, x.placements
        if any(p.is_partial() for p in pl):
            raise ValueError(f"a pending sum ({pl}) cannot be saved")
        blocks = []
        if block_owner(mesh, pl) == me:
            arr, _ = _host_leaf(x.to_local())
            blocks = [([list(b) for b in shard_bounds(x.shape, mesh, pl)],
                       arr)]
        return ShardBlocks(tuple(x.shape), _np_dtype(x), blocks)
    if isinstance(x, torch.Tensor):
        shape, dtype = tuple(x.shape), _np_dtype(x)
    else:
        a = np.asarray(x)
        shape, dtype = a.shape, a.dtype
    if me != 0:
        return ShardBlocks(shape, dtype, [])
    arr, _ = _host_leaf(x)
    return ShardBlocks(shape, dtype, [(_norm_index((), shape), arr)])


def _assemble_blocks(leaves) -> np.ndarray:
    """Merge one leaf's ShardBlocks from every rank file into the global
    host array (a bf16 leaf as its uint16 payload)."""
    first = leaves[0]
    dtype = np.dtype(np.uint16) if first.dtype == BF16 \
        else np.dtype(first.dtype)
    out = np.empty(first.shape, dtype=dtype)
    filled = 0
    for lf in leaves:
        for idx, block in lf.blocks:
            sl = tuple(slice(a, b) for a, b in idx)
            out[sl] = np.asarray(block).reshape(
                tuple(b - a for a, b in idx))
            filled += int(np.prod([b - a for a, b in idx]) or 1)
    if filled < int(np.prod(first.shape) or 1):
        raise CheckpointCorruption(
            f"shard blocks cover {filled} of "
            f"{int(np.prod(first.shape) or 1)} elements of a "
            f"{first.dtype}{list(first.shape)} leaf — missing shard "
            f"data (wrong world size at save, or a lost shard file)")
    return out


def _zip_map(trees, fn):
    """Nested dicts of the same keys in every tree of ``trees``, each
    leaf replaced by ``fn(leaves)`` (one leaf from each tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in first}
    return fn(trees)


class _CrcWriter:
    """A binary file that keeps the CRC32 of what is written through it
    (the shard's checksum without reading the file back)."""

    def __init__(self, f):
        self.f, self.crc = f, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        return self.f.write(b)


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; rename is still atomic
    finally:
        os.close(fd)


class CheckpointManager:
    """Checkpoint manager writing the JAX package's numpy payload.

    Layout: ``<dir>/<step>/state.pkl`` + ``<dir>/<step>/manifest.json``
    (per-leaf shape/dtype/CRC32) + ``<dir>/<step>/meta.json`` (step,
    strategy document, user metadata). In-progress saves stage under
    ``<dir>/tmp-<step>`` and are published by rename. ``writer`` keeps
    the JAX package's argument: "auto" and "numpy" both write the
    pickle; "orbax" is refused (JAX-only).
    """

    #: bound on joining an in-flight async writer thread (see
    #: :meth:`wait`) — generous for slow network filesystems, finite so
    #: wedged storage surfaces as TimeoutError instead of a hang
    WAIT_TIMEOUT_S = 600.0

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False, writer: str = "auto"):
        if writer not in ("auto", "orbax", "numpy"):
            raise ValueError(
                f"writer must be 'auto', 'orbax', or 'numpy', "
                f"got {writer!r}")
        if writer == "orbax":
            raise ValueError("orbax is JAX-only; the port writes the "
                             "numpy payload (writer='auto' or 'numpy')")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.writer = writer
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._restore_seq = 0  # multi-host quorum round: its KV keys

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self):
        """Steps with a complete, *readable* meta.json. Orphaned step
        dirs (no meta — a partial save) and truncated metas are skipped
        with a warning instead of listing as valid and blowing up
        restore later."""
        out = []
        if not os.path.isdir(self.directory):
            return out
        for d in os.listdir(self.directory):
            if not d.isdigit():
                continue  # tmp-<step> staging dirs and strangers
            meta = os.path.join(self.directory, d, "meta.json")
            try:
                with open(meta) as f:
                    json.load(f)
            except (OSError, ValueError) as e:
                log.warning(
                    "checkpoint %s/%s: unreadable meta.json (%s) — "
                    "skipping step", self.directory, d, e)
                continue
            out.append(int(d))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None,
             blocking: Optional[bool] = None):
        """state: nested dicts of tensors (DTensors over a world) or
        numpy arrays (params/opt_state/op state).

        Every leaf (over a world: every block this rank owns) is copied
        to the host before this returns, whether or not the save blocks.
        Collective over a world: EVERY rank must call (with the same
        ``blocking``), and the save takes the two-phase multi-host path.
        ``blocking=False`` (or ``async_save=True`` at construction) then
        runs the file writes (and, over a world, the commit barriers) on
        a background thread — call :meth:`wait` (or any later
        save/restore) to join."""
        from ..parallel.distributed import process_count
        if process_count() > 1:
            # local block extraction — host copies, no collectives
            host_state = _map(state, lambda path, x: _owned_blocks(x))
            write = self._write_multihost
        else:
            host_state, bf16 = _tree_to_host(state)

            def write(step, host_state, meta):
                self._write_step(step, host_state, meta, bf16)
        # one write in flight at a time (bounded: a wedged writer
        # thread must surface as an error, not hang every later save)
        self.wait(timeout_s=self.WAIT_TIMEOUT_S)
        if blocking is None:
            blocking = not self.async_save
        meta = dict(metadata or {})
        if blocking:
            write(step, host_state, meta)
        else:
            def run():
                try:
                    write(step, host_state, meta)
                except BaseException as e:  # surfaced by wait()
                    self._pending_error = e
            t = threading.Thread(target=run, name=f"ckpt-save-{step}",
                                 daemon=True)
            self._pending = t
            t.start()

    def wait(self, timeout_s: Optional[float] = None) -> None:
        """Join an in-flight async save; re-raise its error, if any.

        Bounded: ``timeout_s`` (default :data:`WAIT_TIMEOUT_S`) caps the
        join — a writer thread wedged on dead storage raises
        ``TimeoutError`` instead of hanging every later save/restore
        (and the train loop with them) forever."""
        t = self._pending
        if t is not None:
            t.join(self.WAIT_TIMEOUT_S if timeout_s is None
                   else timeout_s)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint writer thread {t.name!r} still running "
                    f"after {timeout_s or self.WAIT_TIMEOUT_S:.0f}s — "
                    f"storage wedged?")
            self._pending = None
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    def _write_step(self, step: int, host_state, metadata: Dict[str, Any],
                    bf16: Set[str] = frozenset()):
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"tmp-{step}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = _manifest_of(host_state, bf16)
        payload = _map(host_state, lambda path, arr: _BF16Leaf(arr)
                       if _keystr(path) in bf16 else arr)
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            # protocol 5 writes numpy buffers without an extra copy;
            # pickle.load reads every protocol
            pickle.dump(payload, f, protocol=5)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # meta last: its presence inside the staging dir marks the
        # payload complete; the rename below publishes everything at once
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **metadata}, f)
            f.flush()
            os.fsync(f.fileno())
        sdir = self._step_dir(step)
        if os.path.isdir(sdir):
            shutil.rmtree(sdir, ignore_errors=True)
        os.replace(tmp, sdir)
        _fsync_dir(self.directory)
        self._gc()
        # fault-injection hook (resilience/faults.py): checkpoint
        # corruption clauses target the just-published step
        from ..resilience import faults
        if faults.active():
            faults.maybe_corrupt_checkpoint(step, sdir)
        from ..resilience import status
        status.record_checkpoint(step)
        REGISTRY.counter("ff_checkpoint_saves_total",
                         "Completed checkpoint saves").inc()
        REGISTRY.gauge("ff_checkpoint_last_step",
                       "Step of the newest completed checkpoint"
                       ).set(float(step))
        obs_events.record_span("ckpt.save", t0,
                               time.perf_counter() - t0, step=step)

    # ------------------------------------------------------------------
    # multi-host two-phase commit (format v2)
    # ------------------------------------------------------------------
    def _write_multihost(self, step: int, shard_tree,
                         metadata: Dict[str, Any]) -> None:
        """Stage this rank's shard + sidecar, bounded-barrier, then rank
        0 alone commits manifest + meta + atomic rename. Runs on EVERY
        rank (possibly on the async writer thread: the barriers go
        through the coordinator's store, never the process group)."""
        from ..parallel.distributed import process_count, process_index
        from ..resilience import coord, faults
        c = coord.ensure_started()
        rank, world = process_index(), process_count()
        t0 = time.perf_counter()
        # saves are collective and serialized (wait()), so every rank
        # meets these barriers in one order: the store counts each
        # name's uses, and a re-save of a step is a fresh rendezvous
        tmp = os.path.join(self.directory, f"tmp-{step}")
        if rank == 0:
            if os.path.isdir(tmp):
                # stale debris from a killed save (possibly a different
                # world size) must not leak into this step's manifest
                shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
        c.barrier(f"ckpt-begin-{step}")
        # ---- phase 1: stage -----------------------------------------
        shard = os.path.join(tmp, f"shard-{rank}.pkl")
        with open(shard, "wb") as f:
            out = _CrcWriter(f)
            pickle.dump(shard_tree, out, protocol=5)
            f.flush()
            os.fsync(f.fileno())
        crc = out.crc & 0xFFFFFFFF
        with open(os.path.join(tmp, f"shard-{rank}.ok.json"), "w") as f:
            json.dump({"rank": rank, "crc32": crc,
                       "bytes": os.path.getsize(shard),
                       "epoch": c.epoch}, f)
            f.flush()
            os.fsync(f.fileno())
        if faults.active():
            faults.maybe_crash_after_stage(step)
        c.barrier(f"ckpt-stage-{step}")
        # ---- phase 2: commit (rank 0 only) --------------------------
        sdir = self._step_dir(step)
        if rank == 0:
            shards = {}
            for r in range(world):
                ok = os.path.join(tmp, f"shard-{r}.ok.json")
                with open(ok) as f:
                    rec = json.load(f)
                shards[f"shard-{r}.pkl"] = {"crc32": rec["crc32"],
                                            "bytes": rec["bytes"]}
            manifest = {"version": 2, "format": "multihost",
                        "world_size": world, "epoch": c.epoch,
                        "shards": shards}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "world_size": world,
                           **metadata}, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(sdir):
                shutil.rmtree(sdir, ignore_errors=True)
            os.replace(tmp, sdir)
            _fsync_dir(self.directory)
            self._gc()
        # every rank leaves only once the step is committed — "resume
        # from the last committed step" means the same step on all ranks
        c.barrier(f"ckpt-commit-{step}")
        if faults.active():
            faults.maybe_corrupt_shard(
                step, os.path.join(sdir, f"shard-{rank}.pkl"))
        from ..resilience import status
        status.record_checkpoint(step)
        REGISTRY.counter("ff_checkpoint_saves_total",
                         "Completed checkpoint saves").inc()
        REGISTRY.gauge("ff_checkpoint_last_step",
                       "Step of the newest completed checkpoint"
                       ).set(float(step))
        obs_events.record_span("ckpt.save", t0,
                               time.perf_counter() - t0, step=step,
                               multihost=True)

    def _verified_steps(self) -> List[int]:
        """Steps THIS rank can verify cheaply (manifest present, every
        listed shard file's CRC matches; single-process format steps
        verify by full load)."""
        out = []
        for s in self.all_steps():
            sdir = self._step_dir(s)
            mpath = os.path.join(sdir, "manifest.json")
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                if manifest.get("format") == "multihost":
                    for fname, rec in manifest["shards"].items():
                        p = os.path.join(sdir, fname)
                        if _file_crc32(p) != rec["crc32"]:
                            raise CheckpointCorruption(
                                f"step {s}: {fname} CRC mismatch")
                else:
                    self._load_step(s, verify=True)
            except Exception as e:  # noqa: BLE001 — a probe
                log.warning("checkpoint step %d fails local "
                            "verification (%s)", s, e)
                from ..resilience import status
                status.record("corrupt_checkpoints_skipped")
                REGISTRY.counter(
                    "ff_checkpoint_corrupt_skipped_total",
                    "Restore fallbacks past corrupt/partial steps").inc()
                obs_events.counter("ckpt.corrupt_skipped")
                continue
            out.append(s)
        return out

    def _quorum_step(self) -> Optional[int]:
        """Newest step EVERY rank verifies, agreed through the
        coordinator's store; None when no step survives quorum.
        Collective — every rank must call (same restore sequence)."""
        from ..resilience import coord
        mine = self._verified_steps()
        c = coord.ensure_started()
        if c.world <= 1:
            return mine[-1] if mine else None
        self._restore_seq += 1
        prefix = f"ff/restore/e{c.epoch}/s{self._restore_seq}/"
        c.kv.set(prefix + str(c.rank), ",".join(map(str, mine)))
        c.barrier("restore")
        common: Optional[set] = None
        for _, csv in c.kv.dir_get(prefix):
            steps = {int(t) for t in csv.split(",") if t}
            common = steps if common is None else (common & steps)
        if not common:
            return None
        return max(common)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, verify: bool = True):
        """Returns (state, metadata): the state as nested dicts of host
        numpy arrays (bf16 leaves as their uint16 payload; a multi-host
        step assembled whole from every rank's shard).

        Explicit ``step``: load that step or raise (corruption
        included). Default (latest): walk steps newest-first, skipping
        corrupt or partial ones with a warning, and return the newest
        valid step — the auto-resume entry point must survive a torn or
        bit-rotted newest checkpoint. A step in a format the port does
        not read raises :class:`UnsupportedCheckpointFormat` either
        way.

        Over a world the default restore is COLLECTIVE: every rank must
        call it, and all adopt the quorum step (the newest one every
        rank verifies — see :meth:`_quorum_step`)."""
        self.wait(timeout_s=self.WAIT_TIMEOUT_S)
        if step is not None:
            return self._load_step(step, verify=verify)
        from ..parallel.distributed import process_count
        if process_count() > 1:
            s = self._quorum_step()
            if s is None:
                raise FileNotFoundError(
                    f"no checkpoint step in {self.directory} survives "
                    f"all-rank quorum verification")
            # quorum already CRC-verified exactly these files on this
            # rank — re-hashing every shard byte on the load would read
            # the whole checkpoint off shared storage twice
            return self._load_step(s, verify=False)
        candidates = self.all_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._load_step(s, verify=verify)
            except UnsupportedCheckpointFormat:
                raise
            # a corrupt payload can surface as nearly anything (CRC
            # mismatch, UnpicklingError, EOFError, ...); the
            # self-healing walk treats any load failure as "this step is
            # gone" and keeps falling back
            except Exception as e:  # noqa: BLE001
                last_err = e
                log.warning(
                    "checkpoint step %d unusable (%s) — falling back to "
                    "the previous step", s, e)
                from ..resilience import status
                status.record("corrupt_checkpoints_skipped")
                REGISTRY.counter(
                    "ff_checkpoint_corrupt_skipped_total",
                    "Restore fallbacks past corrupt/partial steps").inc()
                obs_events.counter("ckpt.corrupt_skipped")
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.directory} "
            f"(all {len(candidates)} step(s) corrupt; last error: "
            f"{last_err})")

    def _load_step(self, step: int, verify: bool = True):
        t0 = time.perf_counter()
        sdir = self._step_dir(step)
        mpath = os.path.join(sdir, "manifest.json")
        manifest = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        if manifest is not None and manifest.get("format") == "multihost":
            state = self._load_multihost(sdir, manifest, verify=verify)
        else:
            if os.path.isdir(os.path.join(sdir, "state")):
                raise UnsupportedCheckpointFormat(
                    f"checkpoint step {step} in {self.directory} was "
                    f"written by orbax (a state/ directory), which is "
                    f"JAX-only; save it from the JAX package with "
                    f"CheckpointManager(writer='numpy') to read it here")
            with open(os.path.join(sdir, "state.pkl"), "rb") as f:
                state = _Unpickler(f).load()
            if verify and manifest is not None:
                _verify_manifest(state, manifest,
                                 f"checkpoint step {step}")
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        obs_events.record_span("ckpt.restore", t0,
                               time.perf_counter() - t0, step=step)
        return state, meta

    def _load_multihost(self, sdir: str, manifest: Dict[str, Any],
                        verify: bool = True):
        """Assemble the full host state from every rank's shard file —
        readable by a world of ANY size (the elastic shrink/relaunch
        resume path), since each shard carries its global indices."""
        shards = manifest.get("shards")
        if not shards:
            raise CheckpointCorruption(
                f"{sdir}: multi-host manifest lists no shard files")
        trees = []
        for fname, rec in sorted(shards.items()):
            p = os.path.join(sdir, fname)
            if verify and _file_crc32(p) != rec["crc32"]:
                raise CheckpointCorruption(
                    f"{sdir}: {fname} CRC32 != manifest (bit rot or "
                    f"torn shard)")
            with open(p, "rb") as f:
                trees.append(_Unpickler(f).load())
        return _zip_map(trees, _assemble_blocks)

    def verify_step(self, step: int) -> bool:
        """True iff ``step`` loads and passes manifest verification."""
        try:
            self._load_step(step, verify=True)
            return True
        except Exception:  # noqa: BLE001 — a probe, not a loader
            return False

    def _gc(self):
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            victim = steps.pop(0)
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
        # corrupt step dirs (unreadable meta — never restorable) and
        # stale tmp-<step> staging dirs from killed saves would
        # otherwise leak their full-state payloads forever. Safe here:
        # _gc runs after this save's own staging dir was renamed, and
        # the manager keeps one write in flight at a time.
        valid = {str(s) for s in steps}
        for d in os.listdir(self.directory):
            if (d.isdigit() and d not in valid) or d.startswith("tmp-"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)


# ---------------------------------------------------------------------------
# FFModel-level helpers (wired as methods on FFModel)
# ---------------------------------------------------------------------------
def save_model_checkpoint(ff, directory: str, step: Optional[int] = None,
                          max_to_keep: int = 3,
                          extra_metadata: Optional[Dict[str, Any]] = None,
                          manager: Optional[CheckpointManager] = None,
                          blocking: Optional[bool] = None):
    """Save params + optimizer state + op state + step.
    ``extra_metadata`` rides in ``meta.json`` (the supervisor stores the
    dataloader position there); ``manager`` reuses a caller-held
    :class:`CheckpointManager` (required for async saves, whose
    in-flight write the manager tracks). A model compiled over a world
    saves in the multi-host format (collective: every rank calls) with
    its strategy document, the per-leaf optimizer-state shardings and
    the ZeRO assignment in ``meta.json``, as the JAX package records
    them; one process keeps the strategy document ``None``, as a JAX
    model with no strategy does."""
    if blocking is False and manager is None:
        # a throwaway manager's in-flight write could never be joined:
        # its errors would vanish with the object and concurrent saves
        # could race _gc/rename on the directory
        raise ValueError(
            "save_model_checkpoint(blocking=False) requires a caller-"
            "held `manager` so the async write can be awaited (wait())")
    mgr = manager or CheckpointManager(directory, max_to_keep=max_to_keep)
    step = int(step if step is not None else ff._step)
    meta: Dict[str, Any] = {"strategy": None,
                            "batch_size": ff.config.batch_size}
    ex = getattr(ff, "executor", None)
    if ex is not None and ex.strategy is not None:
        from ..search.serialization import _spec_to_json
        meta["strategy"] = {
            name: {"outputs": [_spec_to_json(s) for s in os_.outputs],
                   "weights": {k: _spec_to_json(v)
                               for k, v in os_.weights.items()}}
            for name, os_ in ex.strategy.ops.items()}
        # the placement each optimizer leaf was saved under and the
        # per-parameter ZeRO assignment: the audit trail of a
        # partially-sharded state (restore re-places onto the LIVE
        # model's placements, so any world size or assignment restores)
        if ff.opt_state:
            from .zero import state_sharding_doc
            try:
                meta["opt_shardings"] = state_sharding_doc(ff.opt_state)
            except Exception:  # noqa: BLE001 — metadata is best-effort
                pass
        zero_a = getattr(ex.strategy, "zero", None)
        if zero_a is not None:
            meta["zero"] = zero_a.to_json()
    if extra_metadata:
        meta.update(extra_metadata)
    mgr.save(step,
             {"params": ff.params, "opt_state": ff.opt_state,
              "state": ff.state},
             metadata=meta, blocking=blocking)
    return mgr


def _host_to_torch(arr) -> torch.Tensor:
    """A CPU tensor over one restored host leaf; a bf16 payload (uint16,
    or an ml_dtypes bfloat16 array) becomes a bfloat16 tensor."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16 or str(arr.dtype) == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place_leaf(t: torch.Tensor, arr, where: str) -> None:
    """Copy one restored host leaf into the live tensor ``t`` in place:
    a DTensor gets only this rank's block of the global array (each
    rank is handed its own block, as ``reshard.place_host`` places),
    a plain tensor the whole (``copy_`` casts to its dtype and
    device). Shapes must agree up to a reshape."""
    from ..parallel.distributed import shard_bounds
    from ..parallel.local_ops import is_dtensor
    src = _host_to_torch(arr)
    if src.numel() != t.numel():
        raise ValueError(
            f"checkpoint {where} has shape {tuple(src.shape)}, the "
            f"model's is {tuple(t.shape)}")
    src = src.reshape(t.shape)
    if is_dtensor(t):
        idx = tuple(slice(lo, hi) for lo, hi in
                    shard_bounds(t.shape, t.device_mesh, t.placements))
        t.to_local().copy_(src[idx])
    else:
        t.copy_(src)


def _copy_into(live, saved, what: str) -> None:
    """Copy every saved leaf into the live tensor at the same key path,
    in place (:func:`_place_leaf`). The two trees must hold the same
    leaves."""
    live_leaves = {_keystr(p): t for p, t in _walk(live)}
    saved_leaves = {_keystr(p): a for p, a in _walk(saved)}
    if set(live_leaves) != set(saved_leaves):
        missing = sorted(set(live_leaves) - set(saved_leaves))[:4]
        extra = sorted(set(saved_leaves) - set(live_leaves))[:4]
        raise ValueError(
            f"checkpoint {what} does not match the model: missing "
            f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for key, t in live_leaves.items():
            _place_leaf(t, saved_leaves[key], f"{what}{key}")


def _restore_opt_state(ff, saved) -> None:
    """Restore the optimizer state in place, with the quantized-sync
    residual slot (``ops/quantized_collectives.RESIDUAL_SLOT``) handled
    out of band, as the JAX package does: residuals are per-participant
    error-feedback state whose leading dim is the SYNC DEGREE, so a
    checkpoint from another world sum-folds onto the live degree
    (``refit_residual``: the withheld gradient mass is kept exactly); a
    checkpoint without residuals restores into zeros, one with extras
    drops them. Everything else must match leaf for leaf."""
    from ..ops.quantized_collectives import RESIDUAL_SLOT, refit_residual
    live = ff.opt_state
    if not isinstance(live, dict) or not isinstance(saved, dict):
        _copy_into(live, saved, "opt_state")
        return
    saved = dict(saved)
    saved_res = saved.pop(RESIDUAL_SLOT, None) or {}
    _copy_into({k: v for k, v in live.items() if k != RESIDUAL_SLOT},
               saved, "opt_state")
    with torch.no_grad():
        for lname, ws in (live.get(RESIDUAL_SLOT) or {}).items():
            for wname, tmpl in ws.items():
                src = saved_res.get(lname, {}).get(wname)
                if src is None:
                    arr = np.zeros(tuple(tmpl.shape), np.float32)
                else:
                    arr = refit_residual(
                        np.asarray(src, np.float32).reshape(
                            (-1,) + tuple(tmpl.shape[1:])),
                        int(tmpl.shape[0]))
                _place_leaf(tmpl, arr, f"opt_state[{RESIDUAL_SLOT!r}]"
                            f"[{lname!r}][{wname!r}]")


def restore_model_checkpoint(ff, directory: str,
                             step: Optional[int] = None,
                             with_meta: bool = False):
    """Restore training state into a compiled FFModel; returns the step
    (or ``(step, meta)`` with ``with_meta=True``). Every restored leaf is
    copied into the model's live tensor in place; over a world each rank
    copies only its own block of each DTensor leaf (params, ZeRO's
    ``Shard(dim)`` moments, the quantized sync's residuals), so a step
    saved by any number of ranks restores onto any other. Collective
    over a world (the quorum restore) unless ``step`` is given."""
    mgr = CheckpointManager(directory)
    state, meta = mgr.restore(step)
    _copy_into(ff.params, state["params"], "params")
    _restore_opt_state(ff, state["opt_state"])
    if state.get("state"):
        _copy_into(ff.state, state["state"], "state")
    ff._step = int(meta["step"])
    if with_meta:
        return ff._step, meta
    return ff._step
