"""Error model.

Mirrors the role of the reference's single Error enum (reference:
core/src/err/mod.rs), including the control-flow signal errors the document
pipeline uses (Ignore / RetryWithId / IndexExists) — re-expressed as Python
exception classes because exceptions ARE our control flow here.
"""

from __future__ import annotations


class SurrealError(Exception):
    """Base class for all framework errors."""

    def __str__(self) -> str:  # pragma: no cover - trivial
        return super().__str__() or self.__class__.__name__


# ---------------------------------------------------------------- control flow
class ControlFlow(SurrealError):
    """Signals used internally by the executor/doc pipeline; never user-visible."""


class IgnoreError(ControlFlow):
    """Skip this record's output (reference Error::Ignore).

    mutated=True means the record WAS processed (e.g. RETURN NONE suppressed
    the output); False means it was skipped before any work (cond mismatch).
    """

    def __init__(self, mutated: bool = False):
        super().__init__()
        self.mutated = mutated


class RetryWithIdError(ControlFlow):
    """UPSERT matched an existing unique-index entry: retry against `thing`."""

    def __init__(self, thing):
        super().__init__(f"retry with {thing}")
        self.thing = thing


class BreakError(ControlFlow):
    """BREAK inside FOR/WHILE."""


class ContinueError(ControlFlow):
    """CONTINUE inside FOR/WHILE."""


class ReturnError(ControlFlow):
    """RETURN short-circuit: carries the computed value."""

    def __init__(self, value):
        super().__init__("RETURN")
        self.value = value


# ---------------------------------------------------------------- user errors
class ParseError(SurrealError):
    def __init__(self, message: str, pos: int = -1, line: int = -1, col: int = -1):
        loc = f" at line {line}:{col}" if line >= 0 else ""
        super().__init__(f"Parse error: {message}{loc}")
        self.pos, self.line, self.col = pos, line, col


class TypeError_(SurrealError):
    """Value coercion / cast failure."""


class FieldCheckError(SurrealError):
    """Field ASSERT or TYPE violation."""


class ThrownError(SurrealError):
    """User THROW statement."""

    def __init__(self, value):
        super().__init__(f"An error occurred: {value}")
        self.value = value


class QueryTimeoutError(SurrealError):
    def __init__(self):
        super().__init__("The query was not executed because it exceeded the timeout")


class QueryCancelledError(SurrealError):
    def __init__(self):
        super().__init__("The query was not executed due to a cancelled transaction")


class ComputationDepthError(SurrealError):
    def __init__(self):
        super().__init__("Reached excessive computation depth due to functions, subqueries, or futures")


# ---------------------------------------------------------------- kvs errors
class KvsError(SurrealError):
    pass


class TxFinishedError(KvsError):
    def __init__(self):
        super().__init__("Couldn't update a finished transaction")


class TxReadonlyError(KvsError):
    def __init__(self):
        super().__init__("Couldn't write to a read only transaction")


class TxConflictError(KvsError):
    def __init__(self):
        super().__init__("Failed to commit transaction due to a read or write conflict")


class TxKeyAlreadyExistsError(KvsError):
    def __init__(self):
        super().__init__("The key being inserted already exists")


class TxConditionNotMetError(KvsError):
    def __init__(self):
        super().__init__("Value being checked was not correct")


# ---------------------------------------------------------------- existence
class NotFoundError(SurrealError):
    pass


class NsNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The namespace '{name}' does not exist")


class DbNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The database '{name}' does not exist")


class TbNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The table '{name}' does not exist")


class IxNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The index '{name}' does not exist")


class AzNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The analyzer '{name}' does not exist")


class FcNotFoundError(NotFoundError):
    def __init__(self, name):
        super().__init__(f"The function 'fn::{name}' does not exist")


class RecordExistsError(SurrealError):
    def __init__(self, thing):
        super().__init__(f"Database record `{thing}` already exists")
        self.thing = thing


class IndexExistsError(SurrealError):
    """Unique index violation (reference Error::IndexExists)."""

    def __init__(self, thing, index, value):
        super().__init__(
            f"Database index `{index}` already contains {value}, with record `{thing}`"
        )
        self.thing, self.index, self.value = thing, index, value


# ---------------------------------------------------------------- auth errors
class AuthError(SurrealError):
    pass


class NotAllowedError(AuthError):
    def __init__(self, actor="Anonymous", action="", resource=""):
        super().__init__(f"Not enough permissions to perform this action")
        self.actor, self.action, self.resource = actor, action, resource


class InvalidAuthError(AuthError):
    def __init__(self, msg="There was a problem with authentication"):
        super().__init__(msg)


class FunctionNotAllowedError(SurrealError):
    """Capability denial for a builtin function (reference:
    Error::FunctionNotAllowed)."""

    def __init__(self, name: str):
        super().__init__(f"Function '{name}' is not allowed to be executed")
        self.name = name


class NetTargetNotAllowedError(SurrealError):
    """Capability denial for an outbound network target (reference:
    Error::NetTargetNotAllowed)."""

    def __init__(self, target: str):
        super().__init__(
            f"Access to network target '{target}' is not allowed"
        )
        self.target = target


class MethodNotAllowedError(SurrealError):
    """Capability denial for an RPC method (reference: RpcError +
    capabilities allows_rpc_method)."""

    def __init__(self, method: str):
        super().__init__(f"Method '{method}' is not allowed to be called")
        self.method = method


class RouteNotAllowedError(SurrealError):
    """Capability denial for an HTTP route (reference: Error::ForbiddenRoute)."""

    def __init__(self, route: str):
        super().__init__(f"Forbidden route '{route}'")
        self.route = route


class ExpiredTokenError(AuthError):
    def __init__(self):
        super().__init__("The token has expired")


class InvalidSigninError(AuthError):
    def __init__(self):
        super().__init__("No record was returned")


# ---------------------------------------------------------------- misc
class InvalidStatementTargetError(SurrealError):
    def __init__(self, value):
        super().__init__(f"Can not use '{value}' in a CREATE/UPDATE/DELETE statement")


class InvalidFunctionError(SurrealError):
    def __init__(self, name, message):
        super().__init__(f"There was a problem running the {name}() function. {message}")


class InvalidArgumentsError(SurrealError):
    def __init__(self, name, message):
        super().__init__(f"Incorrect arguments for function {name}(). {message}")
