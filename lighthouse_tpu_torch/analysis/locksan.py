"""graftrace runtime lock sanitizer for the port.

The static half (``sharedstate.py`` + the ``data-race`` rule) *claims*
that certain attributes of thread-shared classes are consistently
guarded by a specific lock.  This module checks those claims against
real interleavings: it wraps the locks the product code creates so the
sanitizer knows, per thread, which locks are held, and installs data
descriptors on every (class, attr) the static model proved guarded.  A
write that reaches such an attribute on a thread-shared instance
without one of its guard locks held is recorded as a report — dynamic
evidence that either the code regressed or the static lockset was
wrong (the "retire the finding" path).

Protocol (Eraser-style, adapted to the GIL):

- every instance attribute starts **exclusive** to the first writing
  thread — ``__init__`` and single-threaded use never report;
- the first write from a *second* thread moves the attribute to
  **shared**; from then on every write must hold one of the attribute's
  guard locks;
- **reads are exempt**: under the GIL a bare read is an atomic
  snapshot, matching the static rule's stance that unlocked reads only
  matter when they feed a write decision (check-then-act — a *static*
  pattern, invisible to per-access runtime checks).

Lock tracking is frame-gated: only locks constructed *directly* by
``lighthouse_tpu_torch``/test code become tracked wrappers, so stdlib
internals (logging, queue, concurrent.futures), torch and any other
package (the JAX package ``lighthouse_tpu`` included) keep their raw
locks.
``Condition(self._lock)`` works because Condition binds the wrapper's
``acquire``/``release``; while a thread is parked in ``wait()`` its
held-set is stale, but a parked thread makes no attribute accesses.

Arming skips what it cannot instrument: classes without an instance
``__dict__`` (``__slots__``), attrs that already exist on the class
(defaults, properties).  Instances created before arming keep their
values under the plain attribute name; the descriptor falls back to it.

Arming a process: ``install_lock_tracking()`` first, then
``arm_repo(repo_root)`` (which imports the planned modules), then the
workload, then read :data:`REPORTS`. Arming mid-process would leave the
locks made before it untracked, and objects made before it would report
falsely.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading

#: sanitizer reports, deduped to one per (class, attr) per session
REPORTS: list = []
_reported: set = set()

_SHARED = "<shared>"
#: the package whose locks are tracked, named exactly (a bare prefix
#: test would also take in ``lighthouse_tpu``)
PACKAGE = "lighthouse_tpu_torch"
_real_lock = threading.Lock
_real_rlock = threading.RLock
_tls = threading.local()


def reset() -> None:
    """Drop accumulated reports (tests that inject races call this)."""
    REPORTS.clear()
    _reported.clear()


def _held() -> dict:
    try:
        return _tls.held
    except AttributeError:
        _tls.held = {}
        return _tls.held


@dataclasses.dataclass
class Report:
    cls: str
    attr: str
    guards: tuple
    thread: str
    detail: str

    def render(self) -> str:
        return (f"{self.cls}.{self.attr}: unguarded write on thread "
                f"{self.thread!r} — static model requires one of "
                f"{list(self.guards)} held ({self.detail})")


class TrackedLock:
    """Wraps a real Lock/RLock; maintains the per-thread held-set."""

    def __init__(self, inner):
        self._inner = inner

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            held = _held()
            held[id(self)] = held.get(id(self), 0) + 1
        return got

    def release(self):
        self._inner.release()
        held = _held()
        n = held.get(id(self), 0) - 1
        if n > 0:
            held[id(self)] = n
        else:
            held.pop(id(self), None)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def held_by_me(self) -> bool:
        if _held().get(id(self), 0) > 0:
            return True
        # a Condition built around this wrapper parks/wakes through the
        # inner lock's _release_save/_acquire_restore; RLock ownership
        # is still queryable there
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            try:
                return bool(owned())
            except Exception:
                return True            # never report on introspection gaps
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"TrackedLock({self._inner!r})"


def _gated(factory):
    import sys

    def make(*args, **kwargs):
        inner = factory(*args, **kwargs)
        mod = sys._getframe(1).f_globals.get("__name__", "")
        # pytest imports tests/test_x.py as plain 'test_x'
        if mod == PACKAGE or mod.startswith((PACKAGE + ".", "tests",
                                             "test_", "conftest",
                                             "__main__")):
            return TrackedLock(inner)
        return inner

    make._locksan = PACKAGE
    return make


def install_lock_tracking() -> None:
    """Patch the threading lock factories (idempotent).  Must run
    before the workload creates product instances; module-level stdlib
    users are unaffected by the frame gate."""
    if getattr(threading.Lock, "_locksan", None) == PACKAGE:
        return
    threading.Lock = _gated(_real_lock)
    threading.RLock = _gated(_real_rlock)


def uninstall_lock_tracking() -> None:
    threading.Lock = _real_lock
    threading.RLock = _real_rlock


def _guard_held(obj, guards) -> bool:
    for g in guards:
        lock = obj.__dict__.get(g)
        if lock is None:
            continue
        if isinstance(lock, TrackedLock):
            if lock.held_by_me():
                return True
            continue
        owned = getattr(lock, "_is_owned", None)
        if owned is not None:
            try:
                if owned():
                    return True
            except Exception:
                return True
        else:
            return True           # untracked plain lock: can't attribute
    return False


class WatchedAttr:
    """Data descriptor enforcing the static guard claim on writes."""

    def __init__(self, cls_name: str, name: str, guards: tuple):
        self.cls_name = cls_name
        self.name = name
        self.guards = guards
        self.slot = "_locksan$" + name

    def _check_write(self, obj) -> None:
        tid = threading.get_ident()
        states = obj.__dict__.setdefault("_locksan$tids", {})
        owner = states.get(self.name)
        if owner is None:
            states[self.name] = tid
            return
        if owner == tid:
            return                     # still thread-exclusive
        states[self.name] = _SHARED
        if _guard_held(obj, self.guards):
            return
        if (self.cls_name, self.name) in _reported:
            return
        _reported.add((self.cls_name, self.name))
        REPORTS.append(Report(
            cls=self.cls_name, attr=self.name, guards=self.guards,
            thread=threading.current_thread().name,
            detail=f"instance {type(obj).__name__} shared across "
                   "threads"))

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        d = obj.__dict__
        if self.slot in d:
            return d[self.slot]
        if self.name in d:
            return d[self.name]        # instance armed after creation
        raise AttributeError(self.name)

    def __set__(self, obj, value):
        self._check_write(obj)
        obj.__dict__[self.slot] = value

    def __delete__(self, obj):
        self._check_write(obj)
        if self.slot in obj.__dict__:
            del obj.__dict__[self.slot]
        else:
            del obj.__dict__[self.name]


_MISSING = object()


def arm_class(cls: type, attr_guards: dict) -> list:
    """Install watched descriptors; returns the attrs actually armed."""
    armed = []
    if getattr(cls, "__dictoffset__", 0) == 0:
        return armed                   # __slots__: no instance __dict__
    for attr, guards in sorted(attr_guards.items()):
        if getattr(cls, attr, _MISSING) is not _MISSING:
            continue                   # class default / property / method
        setattr(cls, attr, WatchedAttr(cls.__name__, attr, tuple(guards)))
        armed.append(attr)
    return armed


# -- static-model-driven arming ----------------------------------------------

def build_plan(repo_root) -> dict:
    """{(import_path, class_qual): {attr: (guard, ...)}} for every
    attribute the static model proves consistently guarded: non-init
    accesses all carry a common lock.  Those are the claims worth
    checking dynamically; looser attrs would only produce Eraser-style
    false positives on queue-hand-off publication."""
    from pathlib import Path

    from .callgraph import CallGraph, build_facts
    from .engine import Project
    from .sharedstate import build_model, scan_module

    root = Path(repo_root)
    project = Project.load(root, [root / PACKAGE])
    data, facts = {}, {}
    for m in project.modules:
        s = scan_module(m.tree, m.relpath)
        if s is not None:
            data[m.relpath] = s
        facts[m.relpath] = build_facts(m.tree, m.relpath)
    model = build_model(data, CallGraph(facts))

    init_methods = {"__init__", "__post_init__", "__new__",
                    "__set_name__"}
    plan: dict = {}
    for (rel, cls_qual), sc in model.items():
        per_attr: dict[str, list] = {}
        for mname, mfacts in sc.methods.items():
            for attr, kind, _line, locks in mfacts.get("acc", ()):
                if attr in sc.sync:
                    continue
                per_attr.setdefault(attr, []).append(
                    (mname, kind, sc.effective_locks(mname, locks)))
        picks: dict[str, tuple] = {}
        for attr, accs in per_attr.items():
            live = [a for a in accs if a[0] not in init_methods]
            writes = [a for a in live if a[1] in ("w", "a")]
            if not writes or not live:
                continue
            common = frozenset.intersection(*[a[2] for a in live])
            guards = tuple(sorted(common & set(sc.locks)))
            if guards:
                picks[attr] = guards
        if picks:
            # repo/lighthouse_tpu_torch/obs/timeseries.py -> import path
            mod = rel.split("/", 1)[1][:-3].replace("/", ".")
            plan[(mod, cls_qual)] = picks
    return plan


def arm_repo(repo_root) -> list[str]:
    """Import each planned module, arm its classes; returns summaries
    like 'lighthouse_tpu_torch.obs.timeseries:SlotSampler(_samples,...)'."""
    summaries = []
    for (mod, cls_qual), picks in sorted(build_plan(repo_root).items()):
        try:
            obj = importlib.import_module(mod)
            for part in cls_qual.split("."):
                obj = getattr(obj, part)
        except Exception:
            continue                   # optional dep gated at import
        armed = arm_class(obj, picks)
        if armed:
            summaries.append(f"{mod}:{cls_qual}({','.join(armed)})")
    return summaries
