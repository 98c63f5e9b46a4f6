"""Execution context.

Role of the reference's Context chain + CursorDoc (reference:
core/src/ctx/context.rs:43-430, core/src/doc/document.rs): a chain of scopes
carrying parameters, the current document binding, depth tracking, options,
deadline, and handles back to the executor (transaction) and the per-query
index executor.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import (
    ComputationDepthError,
    DbNotFoundError,
    NsNotFoundError,
    QueryTimeoutError,
)
from surrealdb_tpu_torch.sql.value import NONE, Thing, copy_value


class CursorDoc:
    """The record a statement is currently processing.

    rid:      record id (Thing) or None for plain values
    current:  the working value (mutated by the doc pipeline)
    initial:  deep copy of the value before this statement touched it
    ir:       index result metadata (doc_id, distance, score) when the record
              came from an index iterator (reference IteratorRecord)
    """

    __slots__ = ("rid", "current", "initial", "ir")

    def __init__(self, rid: Optional[Thing], current: Any, initial: Any = None, ir=None):
        self.rid = rid
        self.current = current
        self.initial = initial if initial is not None else copy_value(current)
        self.ir = ir


class Context:
    __slots__ = (
        "executor",
        "session",
        "parent",
        "params",
        "doc",
        "depth",
        "options",
        "deadline",
        "qe",
        "stm",
    )

    def __init__(self, executor, session, parent: Optional["Context"] = None):
        self.executor = executor
        self.session = session
        self.parent = parent
        self.params: Dict[str, Any] = {}
        self.doc: Optional[CursorDoc] = None
        self.depth = 0
        self.options: Dict[str, Any] = {}
        self.deadline: Optional[float] = None
        self.qe = None  # per-table QueryExecutor (set by the iterator)
        self.stm = None  # current statement view
        if parent is not None:
            self.doc = parent.doc
            self.depth = parent.depth
            self.deadline = parent.deadline
            self.qe = parent.qe
            self.stm = parent.stm

    # ------------------------------------------------------------ scoping
    def _child(self) -> "Context":
        return Context(self.executor, self.session, parent=self)

    @contextmanager
    def child_scope(self):
        """New parameter scope (block / closure body)."""
        yield self._child()

    @contextmanager
    def descend(self):
        """Depth-limited descent into a subquery/function/future."""
        c = self._child()
        c.depth = self.depth + 1
        if c.depth > cnf.MAX_COMPUTATION_DEPTH:
            raise ComputationDepthError()
        yield c

    @contextmanager
    def with_doc(self, doc: Optional[CursorDoc]):
        c = self._child()
        if self.doc is not None:
            c.params["parent"] = self.doc.current
        c.doc = doc
        yield c

    @contextmanager
    def with_doc_value(self, value, rid: Optional[Thing] = None, ir=None):
        c = self._child()
        if self.doc is not None:
            c.params["parent"] = self.doc.current
        c.doc = CursorDoc(rid, value, initial=value, ir=ir)
        yield c

    # ------------------------------------------------------------ params
    def set_param(self, name: str, value: Any) -> None:
        self.params[name] = value

    def get_param(self, name: str) -> Any:
        # document bindings take precedence
        if self.doc is not None:
            if name == "this":
                return self.doc.current
        node: Optional[Context] = self
        while node is not None:
            if name in node.params:
                return node.params[name]
            node = node.parent
        # session-provided values
        if name == "session":
            return self.session.session_value()
        if name == "auth":
            return self.session.auth_value()
        if name == "access":
            return self.session.auth.access or NONE
        if name == "token":
            return self.session.token or NONE
        # database-defined params (DEFINE PARAM)
        v = self._db_param(name)
        if v is not None:
            return v
        return NONE

    def _db_param(self, name: str):
        try:
            ns, db = self.ns_db()
        except (NsNotFoundError, DbNotFoundError):
            return None
        txn = self.txn()
        if txn is None:
            return None
        pa = txn.get_pa(ns, db, name)
        if pa is None:
            return None
        val = pa.get("value")
        from surrealdb_tpu_torch.sql.ast import Expr

        if isinstance(val, Expr):
            return val.compute(self)
        return val

    # ------------------------------------------------------------ options
    def set_option(self, name: str, value: Any) -> None:
        node = self
        while node.parent is not None:
            node = node.parent
        node.options[name.upper()] = value

    def get_option(self, name: str, default: Any = None) -> Any:
        node: Optional[Context] = self
        while node is not None:
            if name.upper() in node.options:
                return node.options[name.upper()]
            node = node.parent
        return default

    @property
    def opt_futures(self) -> bool:
        return bool(self.get_option("FUTURES", True))

    @property
    def opt_import(self) -> bool:
        return bool(self.get_option("IMPORT", False))

    # ------------------------------------------------------------ handles
    def txn(self):
        return self.executor.current_txn()

    def ds(self):
        return self.executor.ds

    def capabilities(self):
        """Datastore-wide allow/deny policy (dbs/capabilities.py)."""
        return self.executor.ds.capabilities

    def ns_db(self):
        ns, db = self.session.ns, self.session.db
        if not ns:
            raise NsNotFoundError("(unset)")
        if not db:
            raise DbNotFoundError("(unset)")
        return ns, db

    def doc_value(self):
        return self.doc.current if self.doc is not None else NONE

    def query_executor(self):
        return self.qe

    # ------------------------------------------------------------ deadline
    @contextmanager
    def with_deadline(self, seconds: Optional[float]):
        c = self._child()
        if seconds is not None:
            dl = time.monotonic() + seconds
            c.deadline = dl if c.deadline is None else min(c.deadline, dl)
        yield c

    def check_deadline(self) -> None:
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryTimeoutError()

    # ------------------------------------------------------------ notifications
    def notify(self, notification) -> None:
        """Buffer a live-query notification; delivered at txn commit
        (reference: executor.rs flush on commit)."""
        self.executor.buffer_notification(notification)
