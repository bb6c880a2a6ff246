"""Per-file analysis cache keyed by content hash.

The per-file stage (parse + every rule's ``check_module`` +
``summarize_module``) is deterministic in (file content, analyzer
code), so its results are cached under
``sha256(file content)`` and invalidated wholesale when the analyzer
itself changes: the cache *salt* hashes every source file of the
``analysis`` package plus ``specs/constants.py`` (the one out-of-scan
input a rule reads — the drift table). A stale salt discards the whole
cache; a changed file misses only its own entry.

This is what keeps full-tree lint wall-time bounded as the tree grows:
an edit re-analyzes one file, the other ~170 come from the cache, and
only the cheap cross-file graph passes rerun.
"""
from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

_CACHE_VERSION = 2


def compute_salt(repo_root: Path) -> str:
    """Hash of the analyzer's own code + the spec-constant table."""
    h = hashlib.sha256(str(_CACHE_VERSION).encode())
    analysis = Path(__file__).resolve().parent
    inputs = sorted(analysis.rglob("*.py"))
    constants = repo_root / "lighthouse_tpu_torch" / "specs" / "constants.py"
    if constants.exists():
        inputs.append(constants)
    for p in inputs:
        if "__pycache__" in p.parts:
            continue
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def content_key(source: str) -> str:
    return hashlib.sha256(source.encode()).hexdigest()


class FileCache:
    """Pickled {content-hash -> per-file payload} map with a salt."""

    def __init__(self, path: Path, salt: str):
        self.path = Path(path)
        self.salt = salt
        self._entries: dict[str, dict] = {}
        self._dirty = False
        try:
            with open(self.path, "rb") as f:
                data = pickle.load(f)
            if data.get("salt") == salt:
                self._entries = data["entries"]
        except (OSError, EOFError, pickle.UnpicklingError, KeyError,
                AttributeError, ImportError, IndexError):
            # unreadable/stale/foreign cache: start empty, overwrite on save
            self._entries = {}

    def get(self, key: str) -> dict | None:
        return self._entries.get(key)

    def put(self, key: str, payload: dict) -> None:
        self._entries[key] = payload
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump({"salt": self.salt, "entries": self._entries},
                            f, protocol=pickle.HIGHEST_PROTOCOL)
            tmp.replace(self.path)      # atomic vs concurrent lint runs
        except OSError:
            pass                        # read-only checkout: run uncached
        self._dirty = False

    def __len__(self) -> int:
        return len(self._entries)
