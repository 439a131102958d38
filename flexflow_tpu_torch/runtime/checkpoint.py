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
``state/`` directory) raises :class:`UnsupportedCheckpointFormat`, and
so does one in the multi-host format (``"format": "multihost"``), which
comes with the parallel lowering. numpy has no bfloat16, so a bf16 leaf
is stored as its raw two-byte payload (a ``uint16`` array) under the
manifest dtype ``"bfloat16"``: its CRC32 is that of the same bytes. A
bf16 leaf the JAX package wrote unpickles only where ``ml_dtypes`` is
installed.

Restore writes into the live tensors with ``copy_`` (same device, dtype
and strides): no second copy of the state on the device, and the fused
Adam's pointer table, cached by ``data_ptr``, stays valid.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from ..obs import events as obs_events
from ..obs.metrics_registry import REGISTRY

log = logging.getLogger("flexflow_tpu_torch")

#: manifest dtype of a bfloat16 leaf (stored as its uint16 payload)
BF16 = "bfloat16"


class CheckpointCorruption(RuntimeError):
    """A checkpoint step failed integrity verification on restore."""


class UnsupportedCheckpointFormat(ValueError):
    """A step in a format the port does not read: orbax's ``state/``
    directory or the multi-host format. Not corruption: the restore walk
    raises it rather than falling back past a valid step."""


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
    got = str(arr.dtype)
    # a bf16 leaf is a uint16 payload when the port wrote it, an
    # ml_dtypes bfloat16 array when the JAX package did
    return got == want or (want == BF16 and arr.dtype == np.uint16)


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
        """state: nested dicts of tensors or numpy arrays
        (params/opt_state/op state).

        Every leaf is copied to the host before this returns, whether or
        not the save blocks. ``blocking=False`` (or ``async_save=True`` at
        construction) then runs the file writes on a background thread —
        call :meth:`wait` (or any later save/restore) to join."""
        host_state, bf16 = _tree_to_host(state)
        # one write in flight at a time (bounded: a wedged writer
        # thread must surface as an error, not hang every later save)
        self.wait(timeout_s=self.WAIT_TIMEOUT_S)
        if blocking is None:
            blocking = not self.async_save
        meta = dict(metadata or {})
        if blocking:
            self._write_step(step, host_state, meta, bf16)
        else:
            def run():
                try:
                    self._write_step(step, host_state, meta, bf16)
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
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            # protocol 5 writes numpy buffers without an extra copy;
            # pickle.load reads every protocol
            pickle.dump(host_state, f, protocol=5)
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
    def restore(self, step: Optional[int] = None, verify: bool = True):
        """Returns (state, metadata): the state as nested dicts of host
        numpy arrays (bf16 leaves as their uint16 payload).

        Explicit ``step``: load that step or raise (corruption
        included). Default (latest): walk steps newest-first, skipping
        corrupt or partial ones with a warning, and return the newest
        valid step — the auto-resume entry point must survive a torn or
        bit-rotted newest checkpoint. A step in a format the port does
        not read raises :class:`UnsupportedCheckpointFormat` either
        way."""
        self.wait(timeout_s=self.WAIT_TIMEOUT_S)
        if step is not None:
            return self._load_step(step, verify=verify)
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
            raise UnsupportedCheckpointFormat(
                f"checkpoint step {step} in {self.directory} is in the "
                f"multi-host format; the port reads it once the parallel "
                f"lowering is ported (ROADMAP queue 1, item 4)")
        if os.path.isdir(os.path.join(sdir, "state")):
            raise UnsupportedCheckpointFormat(
                f"checkpoint step {step} in {self.directory} was written "
                f"by orbax (a state/ directory), which is JAX-only; save "
                f"it from the JAX package with "
                f"CheckpointManager(writer='numpy') to read it here")
        with open(os.path.join(sdir, "state.pkl"), "rb") as f:
            state = pickle.load(f)
        if verify and manifest is not None:
            _verify_manifest(state, manifest, f"checkpoint step {step}")
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        obs_events.record_span("ckpt.restore", t0,
                               time.perf_counter() - t0, step=step)
        return state, meta

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
    in-flight write the manager tracks). The strategy document is
    ``None``: the port runs the single-device default, as a JAX model
    with no strategy does."""
    if blocking is False and manager is None:
        # a throwaway manager's in-flight write could never be joined:
        # its errors would vanish with the object and concurrent saves
        # could race _gc/rename on the directory
        raise ValueError(
            "save_model_checkpoint(blocking=False) requires a caller-"
            "held `manager` so the async write can be awaited (wait())")
    mgr = manager or CheckpointManager(directory, max_to_keep=max_to_keep)
    step = int(step if step is not None else ff._step)
    meta = {"strategy": None, "batch_size": ff.config.batch_size}
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


def _copy_into(live, saved, what: str) -> None:
    """Copy every saved leaf into the live tensor at the same key path,
    in place (``copy_`` casts to the live dtype and device). The two
    trees must hold the same leaves; shapes must agree up to a reshape,
    as the JAX package's restore reshapes."""
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
            src = _host_to_torch(saved_leaves[key])
            if src.numel() != t.numel():
                raise ValueError(
                    f"checkpoint {what}{key} has shape "
                    f"{tuple(src.shape)}, the model's is {tuple(t.shape)}")
            t.copy_(src.reshape(t.shape))


def restore_model_checkpoint(ff, directory: str,
                             step: Optional[int] = None,
                             with_meta: bool = False):
    """Restore training state into a compiled FFModel; returns the step
    (or ``(step, meta)`` with ``with_meta=True``). Every restored leaf is
    copied into the model's live tensor in place."""
    mgr = CheckpointManager(directory)
    state, meta = mgr.restore(step)
    _copy_into(ff.params, state["params"], "params")
    _copy_into(ff.opt_state, state["opt_state"], "opt_state")
    if state.get("state"):
        _copy_into(ff.state, state["state"], "state")
    ff._step = int(meta["step"])
    if with_meta:
        return ff._step, meta
    return ff._step
