"""Access-control SPI + file-style rule engine.

Reference: core/trino-spi spi/security — SystemAccessControl's checkCan*
surface (denials raise AccessDeniedException) — and the file-based access
control plugin (plugin/trino-base-jdbc's is unrelated; the model here is
trino's file-based SystemAccessControl: ordered rules, first match wins,
user regex + catalog/table scoping, allow = all | read-only | none).

The engine holds one AccessControl; enforcement points mirror the reference's:
query admission (DispatchManager), table SELECT at planning time (the analyzer
resolving each table), DML/DDL statement tasks, and SHOW TABLES filtering
(filterTables)."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

__all__ = ["AccessDeniedError", "AccessControl", "AllowAllAccessControl",
           "RuleBasedAccessControl", "GrantBasedAccessControl"]


class AccessDeniedError(PermissionError):
    """reference: spi/security/AccessDeniedException.java."""


class AccessControl:
    """Default-allow base (reference: SystemAccessControl's default methods)."""

    def check_can_execute_query(self, user: str) -> None:
        pass

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        pass

    def check_can_write(self, user: str, catalog: str, table: str,
                        operation: str) -> None:
        """INSERT/DELETE/UPDATE/CREATE/DROP — the reference splits these into
        per-operation checks; the rule engine here gates them all on write
        access, so one hook carries the operation name for the error."""

    def check_can_set_session_property(self, user: str, name: str) -> None:
        pass

    def filter_tables(self, user: str, catalog: str, tables):
        return list(tables)

    def get_row_filter(self, user: str, catalog: str, table: str):
        """SQL predicate text restricting the rows ``user`` may see, or None
        (reference: SystemAccessControl.getRowFilters -> ViewExpression;
        the analyzer wraps the table in the filter before the query sees it)."""
        return None

    def get_column_masks(self, user: str, catalog: str, table: str) -> dict:
        """{column -> SQL expression text} replacing column values for
        ``user`` (reference: SystemAccessControl.getColumnMasks)."""
        return {}

    def grant(self, grantor: str, grantee: str, catalog: str, table: str,
              privileges: set) -> None:
        raise NotImplementedError("this access control does not support GRANT")

    def revoke(self, grantor: str, grantee: str, catalog: str, table: str,
               privileges: set) -> None:
        raise NotImplementedError("this access control does not support REVOKE")


class AllowAllAccessControl(AccessControl):
    pass


class GrantBasedAccessControl(AccessControl):
    """Privilege grants managed through SQL GRANT/REVOKE (reference:
    execution/GrantTask + spi/security/Privilege): default-closed for
    non-admin users; admins hold every privilege and administer grants."""

    _WRITE_PRIVS = {"insert into": "insert", "delete from": "delete",
                    "update": "update", "create table": "create",
                    "drop table": "drop"}
    _ALL = frozenset({"select", "insert", "delete", "update", "create", "drop"})

    def __init__(self, admins=("admin",)):
        self.admins = set(admins)
        self.grants: dict = {}  # (catalog, table) -> {grantee: set(privs)}

    def _privs(self, user: str, catalog: str, table: str) -> set:
        return self.grants.get((catalog, table), {}).get(user, set())

    def _expand(self, privileges) -> set:
        # ALL stores EXPANDED so a later REVOKE of one privilege removes
        # exactly that privilege (an opaque "all" marker would make
        # REVOKE SELECT a silent no-op)
        out = set()
        for p in privileges:
            out |= self._ALL if p == "all" else {p}
        return out

    def grant(self, grantor, grantee, catalog, table, privileges) -> None:
        if grantor not in self.admins:
            raise AccessDeniedError("Access Denied: only admins may GRANT")
        self.grants.setdefault((catalog, table), {}) \
            .setdefault(grantee, set()).update(self._expand(privileges))

    def revoke(self, grantor, grantee, catalog, table, privileges) -> None:
        if grantor not in self.admins:
            raise AccessDeniedError("Access Denied: only admins may REVOKE")
        held = self.grants.get((catalog, table), {}).get(grantee)
        if held is not None:
            held -= self._expand(privileges)

    def check_can_select(self, user, catalog, table) -> None:
        if user in self.admins:
            return
        if "select" not in self._privs(user, catalog, table):
            raise AccessDeniedError(
                f"Access Denied: Cannot select from {catalog}.{table}")

    def check_can_write(self, user, catalog, table, operation) -> None:
        if user in self.admins:
            return
        need = self._WRITE_PRIVS.get(operation, operation)
        if need not in self._privs(user, catalog, table):
            raise AccessDeniedError(
                f"Access Denied: Cannot {operation} {catalog}.{table}")

    def filter_tables(self, user, catalog, tables):
        if user in self.admins:
            return list(tables)
        return [t for t in tables if self._privs(user, catalog, t)]


@dataclasses.dataclass(frozen=True)
class _Rule:
    user_re: re.Pattern
    catalog_re: re.Pattern
    table_re: Optional[re.Pattern]  # None = catalog-level rule
    allow: str  # all | read-only | none
    row_filter: Optional[str] = None  # SQL predicate text (table rules only)
    column_masks: tuple = ()  # ((column, SQL expr text), ...)


class RuleBasedAccessControl(AccessControl):
    """Ordered first-match-wins rules (reference: file-based access control's
    catalog + table rules).  Config shape::

        {"catalogs": [{"user": "ana.*", "catalog": "tpch", "allow": "read-only"},
                      {"catalog": ".*", "allow": "all"}],
         "tables":   [{"user": ".*", "catalog": "mem", "table": "secret.*",
                       "allow": "none"},
                      {"user": "analyst", "table": "orders",
                       "filter": "o_totalprice < 1000",
                       "column_masks": {"o_comment": "null"}}]}

    Omitted keys default to match-everything; an empty rule list allows all.
    ``filter`` / ``column_masks`` (table rules) are the reference's
    ViewExpression row filters and column masks — SQL text the planner splices
    over the table before the query sees it.
    """

    def __init__(self, config: dict):
        def compile_rules(entries, with_table):
            out = []
            for e in entries:
                out.append(_Rule(
                    re.compile(e.get("user", ".*") + r"\Z"),
                    re.compile(e.get("catalog", ".*") + r"\Z"),
                    re.compile(e.get("table", ".*") + r"\Z") if with_table else None,
                    e.get("allow", "all"),
                    e.get("filter"),
                    tuple(sorted((e.get("column_masks") or {}).items()))))
            return out

        self.catalog_rules = compile_rules(config.get("catalogs", ()), False)
        self.table_rules = compile_rules(config.get("tables", ()), True)

    def get_row_filter(self, user: str, catalog: str, table: str):
        for r in self.table_rules:
            if r.row_filter and r.user_re.match(user) \
                    and r.catalog_re.match(catalog) and r.table_re.match(table):
                return r.row_filter
        return None

    def get_column_masks(self, user: str, catalog: str, table: str) -> dict:
        for r in self.table_rules:
            if r.column_masks and r.user_re.match(user) \
                    and r.catalog_re.match(catalog) and r.table_re.match(table):
                return dict(r.column_masks)
        return {}

    def _catalog_access(self, user: str, catalog: str) -> str:
        for r in self.catalog_rules:
            if r.user_re.match(user) and r.catalog_re.match(catalog):
                return r.allow
        return "all" if not self.catalog_rules else "none"

    def _table_access(self, user: str, catalog: str, table: str) -> str:
        for r in self.table_rules:
            if r.user_re.match(user) and r.catalog_re.match(catalog) \
                    and r.table_re.match(table):
                return r.allow
        return "all"  # table rules only narrow; catalog rules gate overall

    def _effective(self, user: str, catalog: str, table: str) -> str:
        cat = self._catalog_access(user, catalog)
        tab = self._table_access(user, catalog, table)
        order = {"none": 0, "read-only": 1, "all": 2}
        return min(cat, tab, key=lambda a: order[a])

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        if self._effective(user, catalog, table) == "none":
            raise AccessDeniedError(
                f"Access Denied: Cannot select from {catalog}.{table}")

    def check_can_write(self, user: str, catalog: str, table: str,
                        operation: str) -> None:
        if self._effective(user, catalog, table) != "all":
            raise AccessDeniedError(
                f"Access Denied: Cannot {operation} {catalog}.{table}")

    def filter_tables(self, user: str, catalog: str, tables):
        return [t for t in tables
                if self._effective(user, catalog, t) != "none"]
