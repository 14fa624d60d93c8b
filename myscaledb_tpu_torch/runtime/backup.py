"""Backup / restore: the port of myscaledb_tpu/runtime/backup.py
(reference: src/Backups/BackupsWorker.h — engine-level BACKUP TABLE ... TO
/ RESTORE).  A backup is a directory of TableStore part directories plus a
manifest carrying table settings and vector-index registrations, the JAX
package's layout, so a backup either package writes the other restores.
Restore re-registers everything into a session on its device (its table
settings and vector-index registrations too); a restored vector table's
scan sidecars are built on its first search, on that device."""

from __future__ import annotations

import json
import os
from dataclasses import asdict

from myscaledb_tpu_torch.config import TableSettings
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.storage.table_store import TableStore


def backup_session(session, path: str, tables=None) -> dict:
    """Write the session's tables (all, or the given names) to ``path``."""
    os.makedirs(path, exist_ok=True)
    names = list(tables) if tables else [
        n for n in session.tables if not n.startswith("system.")]
    with session.vi_lock:
        indices = [dict(i) for i in session.vector_indices]
    manifest = {"tables": [], "vector_indices": indices}
    for name in names:
        t = session.tables[name]
        if getattr(t, "mesh", None) is not None:
            raise ValueError(f"cannot back up distributed table {name!r}; "
                             "back up before distribute()")
        store = TableStore(os.path.join(path, name), device=session.device)
        store.insert(t)
        ts = session.table_settings.get(name)
        manifest["tables"].append({
            "name": name, "rows": t.n_rows,
            "settings": asdict(ts) if ts else None})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    M.increment("BackupsCreated")
    return manifest


def restore_session(session, path: str) -> list:
    """Load a backup into the session; returns restored table names."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    restored = []
    for entry in manifest["tables"]:
        name = entry["name"]
        t = TableStore(os.path.join(path, name),
                       device=session.device).load()
        settings = None
        if entry.get("settings"):
            settings = TableSettings(**entry["settings"])
        session.register(name, t, settings)
        restored.append(name)
    if manifest.get("vector_indices"):
        with session.vi_lock:
            session.vector_indices[:] = list(manifest["vector_indices"])
    M.increment("BackupsRestored")
    return restored
