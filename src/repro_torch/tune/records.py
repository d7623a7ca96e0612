"""Persisted tuning records: measured trials keyed by device x problem.

The port of :mod:`repro.tune.records`.  A tuning run is only worth its cost
if the next invocation on the same machine can reuse it, so every completed
search saves one JSON record keyed by the (host, workload, space)
signature.  The key is hashed -- hostnames, device kinds and JSON-encoded
signatures are hostile as filenames -- and the full signatures are stored
*inside* the record so a load can verify the match instead of trusting the
hash.  :func:`record_key` is the reference's function.

The host signature is that of the device the trials run on, not of what
the machine has: a search on the CPU and one on the card of the same host
get different keys.  Records carry their own schema and a provenance stamp
that names torch, CUDA and the device; they live in
``experiments/tune_torch/`` by default, apart from the reference's.

Schema (``repro_torch.tune.record/v1``)::

    {"schema": "repro_torch.tune.record/v1",
     "key": "<sha256 hex>",
     "host": {...}, "workload": {...}, "space": {...},
     "provenance": {...},
     "budget": int, "rounds": int, "seed": int,
     "best": {"point": {...}, "objective": float, "round_us": float,
              "bytes_per_client_round": float, "staleness_mean": float},
     "trials": [{"point": {...}, "objective": ..., ...}, ...]}
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

SCHEMA = "repro_torch.tune.record/v1"
DEFAULT_CACHE_DIR = os.path.join(".", "experiments", "tune_torch")
PROVENANCE_FIELDS = ("git_commit", "hostname", "torch_version",
                     "cuda_version", "backend", "device_kind",
                     "timestamp_utc")


def host_signature(device=None, x64: bool = True) -> dict:
    """What makes a measurement non-portable: machine + the device the
    trials run on (``cuda`` unless ``device`` says otherwise; raises
    without a card) + precision mode.  Two hosts with equal signatures may
    share tuning records.  The port has no global precision flag: callers
    pass the mode the trials run under (the tuner: ``workload.x64``)."""
    import socket

    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {
        "hostname": socket.gethostname(),
        "backend": dev.type,
        "device_kind": kind,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "x64": bool(x64),
    }


def _git_commit() -> Optional[str]:
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def provenance(host: dict) -> dict:
    """Where/when/what a record came from: the git commit, the machine,
    torch and CUDA, and the device of ``host`` (its signature)."""
    import datetime
    import socket

    import torch

    return {
        "git_commit": _git_commit(),
        "hostname": socket.gethostname(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": host.get("backend"),
        "device_kind": host.get("device_kind"),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }


def _canon(sig):
    """A signature as it reads back from disk (tuples -> lists), so
    in-memory and loaded signatures compare equal."""
    return json.loads(json.dumps(sig))


def record_key(host: dict, workload_sig: dict, space_sig: dict) -> str:
    """sha256 of the canonical JSON of the three signatures."""
    blob = json.dumps({"host": host, "workload": workload_sig,
                       "space": space_sig}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def record_path(key: str, cache_dir: Optional[str] = None) -> str:
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    return os.path.join(cache_dir, f"tune_{key[:16]}.json")


def save_record(record: dict, cache_dir: Optional[str] = None) -> str:
    """Stamp schema + provenance, write atomically, return the path."""
    record = dict(record)
    record["schema"] = SCHEMA
    record.setdefault("provenance", provenance(record.get("host", {})))
    path = record_path(record["key"], cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_record(key: str, cache_dir: Optional[str] = None,
                *, host: Optional[dict] = None,
                workload_sig: Optional[dict] = None,
                space_sig: Optional[dict] = None) -> Optional[dict]:
    """Load and verify the record for ``key``; None on miss or mismatch.

    Verification re-derives the key from the record's own stored
    signatures (and, when the caller passes them, checks its signatures
    too) -- a record whose content was edited or whose hash collides on
    the 16-char filename prefix never silently hits.
    """
    path = record_path(key, cache_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(record, dict):
        return None
    errors = validate_record(record)
    if errors or record.get("key") != key:
        return None
    if host is not None and record["host"] != _canon(host):
        return None
    if workload_sig is not None and record["workload"] != _canon(
            workload_sig):
        return None
    if space_sig is not None and record["space"] != _canon(space_sig):
        return None
    return record


def validate_record(record: dict) -> list:
    """Schema check used by load and the CLI ``--validate`` mode.  Returns
    a list of human-readable problems (empty = valid); a record of another
    schema (the reference's included) is reported as foreign."""
    errors = []
    if record.get("schema") != SCHEMA:
        errors.append(f"schema is {record.get('schema')!r}, want {SCHEMA!r} "
                      "(a foreign record)")
    for field in ("key", "host", "workload", "space", "provenance",
                  "best", "trials"):
        if field not in record:
            errors.append(f"missing field {field!r}")
    if errors:
        return errors
    want = record_key(record["host"], record["workload"], record["space"])
    if record["key"] != want:
        errors.append(f"key {record['key'][:16]} does not match signatures "
                      f"(want {want[:16]})")
    best = record["best"]
    if not isinstance(best, dict) or "point" not in best \
            or "objective" not in best:
        errors.append("best must carry point + objective")
    if not isinstance(record["trials"], list) or not record["trials"]:
        errors.append("trials must be a non-empty list")
    else:
        for i, t in enumerate(record["trials"]):
            for field in ("point", "objective", "round_us",
                          "bytes_per_client_round"):
                if field not in t:
                    errors.append(f"trials[{i}] missing {field!r}")
    for field in PROVENANCE_FIELDS:
        if field not in record["provenance"]:
            errors.append(f"provenance missing {field!r}")
    return errors
