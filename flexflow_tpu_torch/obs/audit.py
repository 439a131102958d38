"""Strategy audit records: per-decision cost breakdowns of a search.

The port of ``flexflow_tpu/obs/audit.py`` (plain Python); the search
(``search/optimizer.py``) and ``FFModel._plan_kernels`` write and
annotate these records.

A fidelity number like ``virtual_fidelity_spearman`` is a single scalar over many (workload, ranker) rows — when
it regresses there is nothing to diff. The audit record persists, per
search, the **per-op predicted cost breakdown of the adopted strategy
AND of the DP baseline** (both priced by the additive evaluator, whose
per-op terms sum exactly to its graph total), so a regression can be
chased decision-by-decision: which op's predicted compute/xfer/sync
moved, and on which side of the searched-vs-DP comparison.

Records land in ``<repo>/.ffcache/torch/strategy_audit_<hash>.json``
next to the port's op-cost and calibration caches (the JAX package's
records are under ``.ffcache/``: the port never writes them); ``<hash>`` is a structural workload
key (op types, names, shapes), so re-searching the same model
overwrites its record and different models never collide. The measured
DP-floor guard appends its timings to the same record when it runs —
predicted and measured sides of one adoption in one file.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

#: the records' directory; None = ``config.default_cache_dir()``
#: (``FF_CACHE_DIR``, else ``<repo>/.ffcache/torch``)
_DEFAULT_DIR: Optional[str] = None

SCHEMA_VERSION = 1


def workload_key(layers: Sequence, n_devices: int = 0) -> str:
    """Structural hash of the layer graph (op types, names, shapes) +
    device count: stable across processes, distinct across models."""
    h = hashlib.sha1()
    h.update(str(n_devices).encode())
    for l in layers:
        h.update(str((getattr(l.op_type, "name", l.op_type), l.name,
                      tuple(tuple(t.shape) for t in l.inputs),
                      tuple(tuple(t.shape) for t in l.outputs))
                     ).encode())
    return h.hexdigest()[:12]


def audit_path(key: str, cache_dir: Optional[str] = None) -> str:
    from ..config import default_cache_dir
    return os.path.join(cache_dir or _DEFAULT_DIR or default_cache_dir(),
                        f"strategy_audit_{key}.json")


def side_record(entries: Sequence[Dict[str, Any]], total_s: float
                ) -> Dict[str, Any]:
    """One side (adopted / dp_baseline) of the audit: per-op entries +
    the evaluator total they sum to."""
    return {
        "total_s": total_s,
        "compute_s": sum(e.get("fwd_s", 0.0) + e.get("bwd_s", 0.0)
                         for e in entries),
        "xfer_s": sum(e.get("xfer_s", 0.0) for e in entries),
        "sync_s": sum(e.get("sync_s", 0.0) for e in entries),
        "per_op": list(entries),
    }


def write_strategy_audit(record: Dict[str, Any], key: str,
                         cache_dir: Optional[str] = None
                         ) -> Optional[str]:
    """Persist one audit record (atomic rename; best-effort — an audit
    write must never kill a compile). Returns the path, or None."""
    path = audit_path(key, cache_dir)
    doc = dict(record, schema=SCHEMA_VERSION, workload_key=key,
               written_unix_s=time.time())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path
    except OSError:  # an unwritable cache dir loses the record only
        return None


def annotate_strategy_audit(path: str, extra: Dict[str, Any]) -> None:
    """Merge extra fields (e.g. the floor guard's measured timings) into
    an existing record; best-effort."""
    try:
        with open(path) as f:
            doc = json.load(f)
        doc.update(extra)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except (OSError, ValueError):  # missing or unreadable record
        pass


def load_strategy_audit(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
