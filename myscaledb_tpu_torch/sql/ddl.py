"""DDL and DML statements: the port of myscaledb_tpu/sql/ddl.py's
statements a user's vector, storage and dashboard workflows and the
goldens run — create, load, index, partition, query, delete, query.

Ported: ``DDLParser`` (``parse_statement``, ``parse_create`` with columns,
``CONSTRAINT ... CHECK length(v) = d``, ``INDEX ... TYPE ... GRANULARITY``,
ENGINE, ORDER BY / PRIMARY KEY, PARTITION BY, TTL and SETTINGS, CREATE
INDEX; ``parse_type``; ``parse_insert`` / ``parse_insert_value`` for
VALUES and SELECT; ``parse_alter`` / ``_parse_alter_command``;
``parse_drop``, ``parse_set``, ``parse_grant``,
``parse_create_dictionary``, DELETE FROM, OPTIMIZE, TRUNCATE,
DETACH/ATTACH, SYSTEM, SHOW and DESCRIBE); ``execute_statement`` for those
statements (tables of the resident engines: the MergeTree family, Join,
Set and every engine the JAX package keeps as a plain resident table);
``apply_table_ttl``, ``empty_table_from_defs``, ``_default_column``,
``rows_to_table``, ``required_privilege``, ``run_materialized_views``,
``_build_dictionary`` and the background part merge.

Since the breadth slice also: views and materialized views
(``run_materialized_views``, once per INSERT statement, over the inserted
rows), ALTER UPDATE / ADD / DROP / MODIFY / MATERIALIZE COLUMN, MODIFY
SETTING, ADD/DROP PROJECTION, DROP CONSTRAINT, Join and Set engines,
CREATE/DROP DICTIONARY over a table and SYSTEM RELOAD DICTIONARY, users,
roles, grants, row policies and quotas, SHOW and DESCRIBE.

File and stream engines, file-sourced dictionaries, INFILE and INSERT ...
FORMAT raise ``NotPortedError`` naming "storage, formats and runtime
state".

Tables live on the session's device.  Each INSERT appends one logical part
(``session._table_parts``, what system.parts lists) and concatenates the
batch onto the table on the device; OPTIMIZE and the background merge
apply the row TTL and collapse the part list.  A partitioned table clusters
each batch by its key on the device and takes its zone maps anew there.
On-disk parts are storage/table_store.py's (``TableStore``,
``open_table``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from myscaledb_tpu_torch.config import TableSettings
from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.core.types import (DataType, Field, type_from_name,
                                            physical_dtype, torch_dtype)
from myscaledb_tpu_torch.core.table import (Table, Column, concat_tables,
                                            to_tensor)
from myscaledb_tpu_torch.errors import NotPortedError
from myscaledb_tpu_torch.sql.lexer import unquote_string
from myscaledb_tpu_torch.sql.parser import Parser, ParseError

STORAGE = "storage, formats and runtime state"

# index builds over at least this many rows run on the background executor
# (smaller ones finish inline, so a follow-up query sees them Built)
BACKGROUND_BUILD_ROWS = 1 << 20


@dataclass
class ColumnDef:
    name: str
    dtype: DataType
    nullable: bool = False
    vector_dim: int = 0
    elem: DataType = None      # element type for ARRAY columns


@dataclass
class CreateTable:
    name: str
    columns: list
    order_by: list = field(default_factory=list)
    if_not_exists: bool = False
    settings: dict = field(default_factory=dict)
    engine: str = "MergeTree"
    engine_args: list = field(default_factory=list)
    vector_indexes: list = field(default_factory=list)
                                # inline (name, col, type, params)
    partition_by: list = field(default_factory=list)
    skip_indexes: list = field(default_factory=list)
    ttl: object = None          # table-level row TTL expression (AST)


@dataclass
class AddSkipIndex:
    table: str
    index: object              # storage.skip_index.SkipIndexDef


@dataclass
class DropSkipIndex:
    table: str
    name: str


@dataclass
class DropPartition:
    table: str
    value: object


@dataclass
class InsertValues:
    table: str
    columns: Optional[list]
    rows: list                    # list of tuples of python literals
    select_sql: Optional[str] = None


@dataclass
class DetachTable:
    table: str


@dataclass
class AttachTable:
    table: str


@dataclass
class AlterDelete:
    table: str
    where: object


@dataclass
class OptimizeTable:
    """OPTIMIZE TABLE t [FINAL]: force a merge, which applies the table's
    row TTL and collapses its logical part list (reference:
    InterpreterOptimizeQuery)."""
    table: str
    final: bool = False


@dataclass
class AlterMulti:
    """ALTER TABLE t cmd1, cmd2, ... — commands run in order."""
    table: str
    commands: list


@dataclass
class AddConstraint:
    """ALTER TABLE t ADD CONSTRAINT name CHECK expr.  Recorded; as in the
    reference's enforce_fixed_vector_length_constraint=0 leniency,
    wrong-length vectors are stored and searches skip them."""
    table: str
    name: str
    expr: object


@dataclass
class AddVectorIndex:
    table: str
    name: str
    column: str
    index_type: str
    params: str = ""
    if_not_exists: bool = False


@dataclass
class DropVectorIndex:
    table: str
    name: str


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class TruncateTable:
    name: str


@dataclass
class SetStatement:
    name: str
    value: object


@dataclass
class SystemStatement:
    action: str                 # "merges_stop" | "merges_start" |
                                # "flush_logs" | "drop_query_cache" |
                                # "reload_dictionary"
    target: Optional[str] = None


@dataclass
class AlterUpdate:
    table: str
    assignments: list           # [(col, expr)]
    where: object


@dataclass
class ModifyTableSetting:
    """ALTER TABLE t MODIFY SETTING name = value."""
    table: str
    name: str
    value: object


@dataclass
class ModifyColumn:
    """ALTER TABLE t MODIFY COLUMN name Type: the column's values cast to
    the new type (the JAX package's grammar has no MODIFY COLUMN)."""
    table: str
    name: str
    type_tokens: object         # (dtype, nullable, vdim, elem)


@dataclass
class DropConstraint:
    table: str
    name: str


@dataclass
class AddColumn:
    table: str
    name: str
    type_tokens: object         # (dtype, nullable, vdim, elem)
    default: object = None      # AST expr or None
    if_not_exists: bool = False


@dataclass
class DropColumn:
    table: str
    name: str


@dataclass
class MaterializeColumn:
    """MATERIALIZE COLUMN / INDEX / PROJECTION: ADD COLUMN materializes its
    DEFAULT at once and derived state is rebuilt per epoch, so nothing is
    left to do but move the epoch."""
    table: str
    name: str


@dataclass
class AddProjection:
    """ALTER TABLE t ADD PROJECTION p (SELECT ... GROUP BY ...): an
    aggregate projection (sql/optimizer.py), built on first matching query
    per mutation epoch."""
    table: str
    name: str
    select_sql: str


@dataclass
class DropProjection:
    table: str
    name: str


@dataclass
class ShowTables:
    pass


@dataclass
class CreateUser:
    name: str
    password: Optional[str] = None
    if_not_exists: bool = False


@dataclass
class CreateRole:
    name: str
    if_not_exists: bool = False


@dataclass
class DropPrincipal:
    kind: str                   # "user" | "role" | "quota"
    name: str
    if_exists: bool = False


@dataclass
class GrantStmt:
    privs: list                 # privilege names, or role names if is_role
    target: Optional[str]       # table name or '*' (None for role grants)
    grantees: list
    is_role: bool = False


@dataclass
class RevokeStmt:
    privs: list
    target: Optional[str]
    grantees: list
    is_role: bool = False


@dataclass
class CreateRowPolicy:
    name: str
    table: str
    using_expr: object
    using_sql: str
    to_users: Optional[list]    # None = TO ALL


@dataclass
class DropRowPolicy:
    name: str
    table: str


@dataclass
class CreateQuota:
    name: str
    interval_s: float
    limits: dict
    to_users: Optional[list]


@dataclass
class CreateView:
    name: str
    select_sql: str
    materialized: bool = False
    to_table: Optional[str] = None
    populate: bool = False
    if_not_exists: bool = False


@dataclass
class CreateDictionary:
    name: str
    columns: list               # ColumnDef list
    primary_key: str
    source_kind: str            # "table" | "file"
    source_arg: str             # table name or file path
    source_format: Optional[str]
    layout: str
    if_not_exists: bool = False


@dataclass
class DropDictionary:
    name: str
    if_exists: bool = False


@dataclass
class ShowGrants:
    user: Optional[str] = None


@dataclass
class ShowAccess:
    what: str                   # users | roles | quotas | row_policies |
                                # dictionaries


@dataclass
class DescribeTable:
    name: str


# statements that read the catalog and change nothing
READ_ONLY_STATEMENTS = (ShowTables, DescribeTable, ShowGrants, ShowAccess)
# statements that change who may read what, and no data
ACCESS_STATEMENTS = (CreateUser, CreateRole, DropPrincipal, GrantStmt,
                     RevokeStmt, CreateRowPolicy, DropRowPolicy, CreateQuota)


class DDLParser(Parser):

    def parse_statement(self):
        t = self.peek()
        up = t.upper
        if up == "CREATE":
            return self.parse_create()
        if up == "INSERT":
            return self.parse_insert()
        if up == "DROP":
            return self.parse_drop()
        if up == "ALTER":
            return self.parse_alter()
        if up == "OPTIMIZE":
            self.next()
            self.expect_kw("TABLE")
            name = self.parse_table_name()
            final = bool(self.take_kw("FINAL"))
            return OptimizeTable(name, final)
        if up == "TRUNCATE":
            self.next()
            self.take_kw("TABLE")
            return TruncateTable(self.parse_table_name())
        if up == "DETACH":
            self.next()
            self.expect_kw("TABLE")
            return DetachTable(self.parse_table_name())
        if up == "ATTACH":
            self.next()
            self.expect_kw("TABLE")
            return AttachTable(self.parse_table_name())
        if up == "SET":
            return self.parse_set()
        if up == "SYSTEM":
            self.next()
            if self.take_kw("RELOAD"):
                self.take_kw("DICTIONARY") or self.take_kw("DICTIONARIES")
                target = self.next().text if self.peek().kind != "eof" \
                    else None
                return SystemStatement("reload_dictionary", target)
            if self.take_kw("FLUSH"):
                self.take_kw("LOGS")
                return SystemStatement("flush_logs")
            if self.take_kw("DROP"):
                self.take_kw("QUERY")
                self.expect_kw("CACHE")
                return SystemStatement("drop_query_cache")
            if self.at_kw("STOP", "START"):
                # STOP/START MERGES [table]: pauses or resumes the
                # background part merge of one table (or of every table)
                action = "merges_" + self.next().text.lower()
                self.take_kw("MERGES")
                target = self.next().text if self.peek().kind != "eof" \
                    else None
                return SystemStatement(action, target)
            raise ParseError("unsupported SYSTEM statement")
        if up in ("GRANT", "REVOKE"):
            return self.parse_grant(revoke=up == "REVOKE")
        if up == "SHOW":
            self.next()
            if self.take_kw("GRANTS"):
                return ShowGrants(self.next().text if self.take_kw("FOR")
                                  else None)
            for kw, what in (("USERS", "users"), ("ROLES", "roles"),
                             ("QUOTAS", "quotas"),
                             ("DICTIONARIES", "dictionaries")):
                if self.take_kw(kw):
                    return ShowAccess(what)
            if self.take_kw("ROW"):
                self.expect_kw("POLICIES")
                return ShowAccess("row_policies")
            self.expect_kw("TABLES")
            return ShowTables()
        if up in ("DESCRIBE", "DESC"):
            self.next()
            self.take_kw("TABLE")
            return DescribeTable(self.parse_table_name())
        if up == "DELETE":
            # standalone lightweight delete: DELETE FROM t WHERE expr (the
            # rewrite semantics are shared with ALTER TABLE ... DELETE)
            self.next()
            self.expect_kw("FROM")
            table = self.parse_table_name()
            self.expect_kw("WHERE")
            return AlterDelete(table, self.parse_expr())
        return None   # fall through to SELECT

    def parse_alter(self):
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        table = self.parse_table_name()
        cmds = [self._parse_alter_command(table)]
        while self.take_punct(","):
            cmds.append(self._parse_alter_command(table))
        return cmds[0] if len(cmds) == 1 else AlterMulti(table, cmds)

    def _vector_index_params(self) -> str:
        """The (...) after TYPE X, stored unquoted: system.vector_indices
        re-quotes it in its expr column (IVFFLAT('ncentroids = 1'))."""
        params = ""
        if self.take_punct("("):
            depth, parts = 1, []
            while depth and self.peek().kind != "eof":
                tok = self.next()
                depth += (tok.text == "(") - (tok.text == ")")
                if depth:
                    parts.append(unquote_string(tok.text)
                                 if tok.kind == "string" else tok.text)
            params = " ".join(parts)
        return params

    def _parse_alter_command(self, table):
        if self.take_kw("DELETE"):
            self.expect_kw("WHERE")
            return AlterDelete(table, self.parse_expr())
        if self.take_kw("UPDATE"):
            assignments = []
            while True:
                col = self.next().text
                self.expect_punct("=")
                assignments.append((col, self.parse_expr()))
                if not self.take_punct(","):
                    break
            self.expect_kw("WHERE")
            return AlterUpdate(table, assignments, self.parse_expr())
        if self.take_kw("MATERIALIZE"):
            if not (self.take_kw("INDEX") or self.take_kw("PROJECTION")):
                self.expect_kw("COLUMN")
            return MaterializeColumn(table, self.next().text)
        if self.take_kw("MODIFY"):
            if self.take_kw("COLUMN"):
                self._take_if_exists()
                name = self.next().text.strip("`")
                return ModifyColumn(table, name, self.parse_type())
            # MODIFY SETTING a = 1[, b = 2 ...]
            self.expect_kw("SETTING")

            def one():
                name = self.next().text
                self.expect_punct("=")
                tok = self.next()
                val = unquote_string(tok.text) if tok.kind == "string" \
                    else tok.text
                try:
                    val = int(val)
                except (TypeError, ValueError):
                    pass
                return ModifyTableSetting(table, name, val)

            cmds = [one()]
            # a following "name =" continues the SETTING list; anything
            # else is the next ALTER command
            while self.at_punct(",") and self.peek(2).text == "=":
                self.next()
                cmds.append(one())
            return cmds[0] if len(cmds) == 1 else AlterMulti(table, cmds)
        if self.take_kw("ADD"):
            if self.at_kw("INDEX"):
                return AddSkipIndex(table, self._parse_skip_index())
            if self.take_kw("CONSTRAINT"):
                name = self.next().text
                self.expect_kw("CHECK")
                return AddConstraint(table, name, self.parse_expr())
            if self.take_kw("COLUMN"):
                ine = self._take_if_not_exists()
                name = self.next().text.strip("`")
                tt = self.parse_type()
                default = None
                if self.take_kw("DEFAULT") or self.take_kw("MATERIALIZED"):
                    default = self.parse_expr()
                return AddColumn(table, name, tt, default, ine)
            if self.take_kw("PROJECTION"):
                name = self.next().text
                self.expect_punct("(")
                start = self.peek().pos
                depth, end = 1, len(self.sql)
                while depth and self.peek().kind != "eof":
                    tok = self.next()
                    depth += (tok.text == "(") - (tok.text == ")")
                    if depth == 0:
                        end = tok.pos
                return AddProjection(table, name,
                                     self.sql[start:end].strip())
            self.expect_kw("VECTOR")
            self.expect_kw("INDEX")
            name = self.next().text
            column = self.next().text
            self.expect_kw("TYPE")
            itype = self.next().text
            return AddVectorIndex(table, name, column, itype,
                                  self._vector_index_params())
        if self.take_kw("DROP"):
            if self.take_kw("PARTITION"):
                # the partition's key value: a literal, quoted or not
                tok = self.next()
                val = unquote_string(tok.text) if tok.kind == "string" \
                    else tok.text
                for conv in (int, float):
                    try:
                        val = conv(val)
                        break
                    except (TypeError, ValueError):
                        pass
                return DropPartition(table, val)
            if self.take_kw("INDEX"):
                return DropSkipIndex(table, self.next().text)
            if self.take_kw("PROJECTION"):
                return DropProjection(table, self.next().text)
            if self.take_kw("CONSTRAINT"):
                return DropConstraint(table, self.next().text)
            if self.take_kw("COLUMN"):
                self._take_if_exists()
                return DropColumn(table, self.next().text.strip("`"))
            self.expect_kw("VECTOR")
            self.expect_kw("INDEX")
            return DropVectorIndex(table, self.next().text)
        raise ParseError("unsupported ALTER TABLE clause")

    def parse_create(self):
        self.expect_kw("CREATE")
        if self.take_kw("VECTOR"):
            # CREATE VECTOR INDEX [IF NOT EXISTS] name ON table col TYPE X
            self.expect_kw("INDEX")
            ine = self._take_if_not_exists()
            name = self.next().text
            self.expect_kw("ON")
            table = self.parse_table_name()
            column = self.next().text
            self.expect_kw("TYPE")
            itype = self.next().text
            return AddVectorIndex(table, name, column, itype,
                                  self._vector_index_params(), ine)
        if self.take_kw("INDEX"):
            # CREATE INDEX [IF NOT EXISTS] name ON table(col) TYPE kind ...
            self._take_if_not_exists()
            iname = self.next().text
            self.expect_kw("ON")
            table = self.parse_table_name()
            return AddSkipIndex(table, self._skip_index_tail(iname))
        if self.take_kw("USER"):
            ine = self._take_if_not_exists()
            name = self.next().text
            password = None
            if self.take_kw("IDENTIFIED"):
                self.take_kw("WITH") and self.next()   # auth type, ignored
                self.expect_kw("BY")
                password = unquote_string(self.next().text)
            return CreateUser(name, password, ine)
        if self.take_kw("ROLE"):
            ine = self._take_if_not_exists()
            return CreateRole(self.next().text, ine)
        if self.take_kw("ROW"):
            self.expect_kw("POLICY")
            self._take_if_not_exists()
            name = self.next().text
            self.expect_kw("ON")
            table = self.parse_table_name()
            if self.take_kw("FOR"):
                self.expect_kw("SELECT")
            self.expect_kw("USING")
            start = self.peek().pos
            expr = self.parse_expr()
            end = self.peek().pos if self.peek().kind != "eof" else \
                len(self.sql)
            return CreateRowPolicy(name, table, expr,
                                   self.sql[start:end].strip(),
                                   self._parse_to_users())
        if self.take_kw("DICTIONARY"):
            return self.parse_create_dictionary()
        if self.take_kw("VIEW"):
            ine = self._take_if_not_exists()
            name = self.parse_table_name()
            self.expect_kw("AS")
            return CreateView(name, self.sql[self.peek().pos:], False,
                              if_not_exists=ine)
        if self.take_kw("MATERIALIZED"):
            self.expect_kw("VIEW")
            ine = self._take_if_not_exists()
            name = self.parse_table_name()
            to_table = None
            if self.take_kw("TO"):
                to_table = self.parse_table_name()
            populate = False
            # ENGINE = ... ORDER BY ... of the inner table: the view's rows
            # live in a resident table whatever the engine (the JAX
            # grammar takes no ENGINE clause here)
            while not self.at_kw("AS") and self.peek().kind != "eof":
                populate |= self.next().upper == "POPULATE"
            self.expect_kw("AS")
            return CreateView(name, self.sql[self.peek().pos:], True,
                              to_table, populate, ine)
        if self.take_kw("QUOTA"):
            self._take_if_not_exists()
            name = self.next().text
            interval_s = 3600.0
            if self.take_kw("FOR"):
                self.expect_kw("INTERVAL")
                n = float(self.next().text)
                unit = self.next().upper
                interval_s = n * {"SECOND": 1, "MINUTE": 60, "HOUR": 3600,
                                  "DAY": 86400, "WEEK": 604800,
                                  "MONTH": 2629800}.get(unit, 1)
            limits = {}
            if self.take_kw("MAX"):
                while True:
                    key = self.next().text.lower()
                    self.expect_punct("=")
                    limits[key] = float(self.next().text)
                    if not self.take_punct(","):
                        break
            return CreateQuota(name, interval_s, limits,
                               self._parse_to_users())
        self.expect_kw("TABLE")
        ine = self._take_if_not_exists()
        name = self.parse_table_name()
        self.expect_punct("(")
        cols = []
        vec_defs = []
        skip_defs = []
        while True:
            if self.at_kw("INDEX"):
                skip_defs.append(self._parse_skip_index())
            elif self.at_kw("VECTOR") and self.peek(1).upper == "INDEX":
                # inline VECTOR INDEX name col TYPE X('params') — guarded on
                # the second token: `vector` is also a popular column name
                self.next()
                self.expect_kw("INDEX")
                vname = self.next().text
                vcol = self.next().text
                self.expect_kw("TYPE")
                vtype = self.next().text
                vec_defs.append((vname, vcol, vtype,
                                 self._vector_index_params()))
            elif self.take_kw("CONSTRAINT"):
                # CONSTRAINT x CHECK length(v) = N fixes a vector dim
                self.next()                       # constraint name
                self.expect_kw("CHECK")
                chk = self.parse_expr()
                self._apply_length_constraint(cols, chk)
            else:
                cname = self.next().text
                ctype, nullable, vdim, elem = self.parse_type()
                # DEFAULT/CODEC/TTL clauses: accepted (storage details the
                # resident layout does not need)
                if self.take_kw("DEFAULT"):
                    self.parse_expr()
                if self.take_kw("CODEC"):
                    self._paren_blob()
                if self.take_kw("TTL"):
                    self.parse_expr()
                cols.append(ColumnDef(cname, ctype, nullable, vdim, elem))
            if not self.take_punct(","):
                break
        self.expect_punct(")")
        order_by = []
        partition_by = []
        settings = {}
        engine = "MergeTree"
        engine_args = []
        ttl = None
        # engine / order by / primary key / settings tail
        while self.peek().kind != "eof":
            if self.take_kw("ENGINE"):
                self.take_punct("=")
                engine = self.next().text
                if self.take_punct("("):
                    depth = 1
                    cur = []
                    while depth and self.peek().kind != "eof":
                        tok = self.next()
                        depth += (tok.text == "(") - (tok.text == ")")
                        if depth == 1 and tok.text == ",":
                            engine_args.append(" ".join(cur))
                            cur = []
                        elif depth:
                            cur.append(unquote_string(tok.text)
                                       if tok.kind == "string" else tok.text)
                    if cur:
                        engine_args.append(" ".join(cur))
            elif self.at_kw("ORDER") or self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("BY" if self.toks[self.i - 1].upper == "ORDER"
                               else "KEY")
                if self.take_punct("("):
                    order_by.append(self.next().text)
                    while self.take_punct(","):
                        order_by.append(self.next().text)
                    self.expect_punct(")")
                else:
                    order_by.append(self.next().text)
            elif self.at_kw("PARTITION"):
                # PARTITION BY col | (col, ...): each inserted batch is
                # clustered by the key, so the zone maps prune whole
                # partitions, and ALTER ... DROP PARTITION deletes by its
                # first column.  As in the JAX package, the key is read as
                # column names: an expression's first token is taken and
                # the rest skipped, and a key that names no column does
                # not cluster.
                self.next()
                self.expect_kw("BY")
                if self.take_punct("("):
                    partition_by.append(self.next().text)
                    while self.take_punct(","):
                        partition_by.append(self.next().text)
                    self.expect_punct(")")
                else:
                    partition_by.append(self.next().text)
            elif self.take_kw("TTL"):
                # table-level row TTL: rows whose TTL time has passed are
                # deleted at OPTIMIZE and merge time (TTLDeleteAlgorithm)
                ttl = self.parse_expr()
                self.take_kw("DELETE")
            elif self.take_kw("SETTINGS"):
                while self.peek().kind != "eof":
                    sname = self.next().text
                    self.expect_punct("=")
                    sval = self.next().text
                    settings[sname] = sval.strip("'")
                    if not self.take_punct(","):
                        break
            else:
                self.next()   # tolerate unknown clauses
        return CreateTable(name, cols, order_by, ine, settings, engine,
                           engine_args, vec_defs, partition_by, skip_defs,
                           ttl)

    def _parse_skip_index(self):
        """INDEX name col TYPE set(N)|bloom_filter([fp])|ngrambf_v1(n, ...)|
        tokenbf_v1(...) [GRANULARITY g] (reference grammar:
        ParserCreateQuery.cpp index declarations)."""
        self.expect_kw("INDEX")
        return self._skip_index_tail(self.next().text)

    def _skip_index_tail(self, iname: str):
        """col TYPE kind[(params)] [GRANULARITY g] of a skip index (the
        column bare, in parentheses, or after a space in parentheses).
        Only the first parameter is kept: a set's size, a bloom's false
        positive rate, an n-gram size; the filter geometry comes from the
        data, as in the JAX package."""
        from myscaledb_tpu_torch.storage.skip_index import SkipIndexDef
        if self.take_punct("("):
            col = self.next().text
            self.expect_punct(")")
        else:
            col = self.next().text
            if self.take_punct("("):
                col = self.next().text
                self.expect_punct(")")
        self.expect_kw("TYPE")
        kind = self.next().text.lower()
        kind = {"ngrambf_v1": "ngrambf", "tokenbf_v1": "tokenbf"}.get(
            kind, kind)
        param = 0.0
        if self.take_punct("("):
            first = True
            while not self.take_punct(")"):
                tok = self.next().text
                if first:
                    param = float(tok)
                    first = False
                self.take_punct(",")
        gran = 1
        if self.take_kw("GRANULARITY"):
            gran = int(self.next().text)
        return SkipIndexDef(iname, col, kind, param, gran)

    def _apply_length_constraint(self, cols, chk):
        # recognize length(col) = N
        from myscaledb_tpu_torch.sql.ast import BinOp, FuncCall, Ident, \
            Literal
        if isinstance(chk, BinOp) and chk.op == "=" and \
                isinstance(chk.left, FuncCall) and \
                chk.left.name.lower() == "length" and \
                isinstance(chk.left.args[0], Ident) and \
                isinstance(chk.right, Literal):
            cname = chk.left.args[0].name
            for c in cols:
                if c.name == cname and c.dtype is DataType.FLOAT32_VECTOR:
                    c.vector_dim = int(chk.right.value)

    def parse_type(self):
        t = self.next()
        name = t.text
        vdim = 0
        if name.lower() == "nullable":
            self.expect_punct("(")
            dtype, _, vdim, elem = self.parse_type()
            self.expect_punct(")")
            return dtype, True, vdim, elem
        if name.lower() == "lowcardinality":
            self.expect_punct("(")
            dtype, nullable, vdim, elem = self.parse_type()
            self.expect_punct(")")
            return dtype, nullable, vdim, elem
        low = name.lower()
        if low == "fixedstring":
            # FixedString(N) -> dictionary-encoded String; the byte width N
            # rides the vdim slot and lands in Field.fixed_len — the binary
            # vector carrier of distance()
            toks = self._paren_blob()
            try:
                fixed_n = int(toks[0].text) if toks else 0
            except (ValueError, IndexError):
                fixed_n = 0
            return DataType.STRING, False, fixed_n, None
        if low == "uuid":
            return DataType.STRING, False, 0, None
        if low == "aggregatefunction":
            # AggregateFunction(f, T): the -State combinators' state
            # strings (the JAX grammar has no such type)
            self._paren_blob()
            return DataType.STRING, False, 0, None
        if low == "simpleaggregatefunction":
            # SimpleAggregateFunction(f, T) stores plain T values
            self.expect_punct("(")
            self.next()
            self.expect_punct(",")
            out = self.parse_type()
            self.expect_punct(")")
            return out
        if low in ("enum8", "enum16", "enum"):
            self._paren_blob()
            return DataType.STRING, False, 0, None
        if low in ("decimal", "decimal32", "decimal64", "decimal128"):
            # documented approximation: Decimal maps to Float64
            if self.peek().kind == "punct" and self.peek().text == "(":
                self._paren_blob()
            return DataType.FLOAT64, False, 0, None
        if low == "datetime64":
            if self.peek().kind == "punct" and self.peek().text == "(":
                self._paren_blob()   # precision: stored at second resolution
            return DataType.DATETIME, False, 0, None
        if name.lower() == "array":
            self.expect_punct("(")
            inner = self.next().text
            # Array(Float32[, dim]) stays the fixed-width vector-search
            # type; every other element type is a general ragged ARRAY
            if inner.lower() in ("float32", "float"):
                if self.take_punct(","):
                    vdim = int(self.next().text)
                self.expect_punct(")")
                return DataType.FLOAT32_VECTOR, False, vdim, None
            try:
                elem = type_from_name(inner)
            except ValueError:
                raise ParseError(f"unknown array element type {inner!r}")
            self.expect_punct(")")
            return DataType.ARRAY, False, 0, elem
        try:
            return type_from_name(name), False, 0, None
        except ValueError:
            raise ParseError(f"unknown type {name!r}")

    def _paren_blob(self) -> list:
        """Consume a balanced (...) group, returning the inner tokens."""
        self.expect_punct("(")
        depth, toks = 1, []
        while depth and self.peek().kind != "eof":
            t = self.next()
            depth += (t.text == "(") - (t.text == ")")
            if depth:
                toks.append(t)
        return toks

    def parse_create_dictionary(self):
        """CREATE DICTIONARY name (col Type, ...) PRIMARY KEY k
        SOURCE(TABLE 'src' | CLICKHOUSE(TABLE 'src') | FILE(PATH 'p'
        FORMAT 'CSV')) LAYOUT(FLAT()|HASHED()|COMPLEX_KEY_HASHED())
        LIFETIME(...)."""
        ine = self._take_if_not_exists()
        name = self.parse_table_name()
        self.expect_punct("(")
        cols = []
        while True:
            cname = self.next().text
            ctype, nullable, vdim, elem = self.parse_type()
            if self.take_kw("DEFAULT"):
                self.parse_expr()
            cols.append(ColumnDef(cname, ctype, nullable, vdim, elem))
            if not self.take_punct(","):
                break
        self.expect_punct(")")
        primary_key = None
        source_kind = source_arg = source_format = None
        layout = "hashed"
        while self.peek().kind != "eof":
            kw = self.next().upper
            if kw == "PRIMARY":
                self.expect_kw("KEY")
                primary_key = self.next().text
            elif kw == "SOURCE":
                toks = self._paren_blob()
                strings = [unquote_string(t.text) for t in toks
                           if t.kind == "string"]
                words = [t.upper for t in toks if t.kind != "string"]
                source_kind = "file" if "FILE" in words else "table"
                source_arg = strings[0] if strings else ""
                if source_kind == "file" and len(strings) > 1:
                    source_format = strings[1]
            elif kw == "LAYOUT":
                toks = self._paren_blob()
                if toks:
                    layout = toks[0].text.lower()
            elif kw == "LIFETIME":
                self._paren_blob()   # accepted; snapshot semantics
            else:
                raise ParseError(f"unexpected {kw} in CREATE DICTIONARY")
        if primary_key is None:
            raise ParseError("CREATE DICTIONARY requires PRIMARY KEY")
        if source_kind is None:
            raise ParseError("CREATE DICTIONARY requires SOURCE(...)")
        return CreateDictionary(name, cols, primary_key, source_kind,
                                source_arg, source_format, layout, ine)

    def _parse_to_users(self):
        """TO ALL | TO name [, name...]; None means ALL."""
        if not self.take_kw("TO") or self.take_kw("ALL"):
            return None
        users = [self.next().text]
        while self.take_punct(","):
            users.append(self.next().text)
        return users

    def _parse_priv_list(self) -> list:
        """Privilege names up to ON/TO/FROM; multi-word privileges
        ('ACCESS MANAGEMENT', 'CREATE TABLE') joined with spaces."""
        privs, words = [], []
        while True:
            t = self.peek()
            if t.kind == "eof" or t.upper in ("ON", "TO", "FROM"):
                break
            if self.take_punct(","):
                privs.append(" ".join(words))
                words = []
                continue
            words.append(self.next().text)
        if words:
            privs.append(" ".join(words))
        return privs

    def _parse_grant_target(self) -> str:
        """* | *.* | db.* | table"""
        if self.take_punct("*"):
            if self.take_punct("."):
                self.expect_punct("*")
            return "*"
        name = self.parse_table_name()
        if self.take_punct("."):
            self.expect_punct("*")
            return "*"          # one implicit database: db.* == *
        return name

    def parse_grant(self, revoke: bool):
        self.expect_kw("REVOKE" if revoke else "GRANT")
        privs = self._parse_priv_list()
        cls = RevokeStmt if revoke else GrantStmt
        target = self._parse_grant_target() if self.take_kw("ON") else None
        self.expect_kw("FROM" if revoke else "TO")
        grantees = [self.next().text]
        while self.take_punct(","):
            grantees.append(self.next().text)
        # without ON it grants roles: GRANT r TO u / REVOKE r FROM u
        return cls(privs, target, grantees, is_role=target is None)

    def parse_insert(self):
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        name = self.parse_table_name()
        columns = None
        if self.take_punct("("):
            columns = [self.next().text]
            while self.take_punct(","):
                columns.append(self.next().text)
            self.expect_punct(")")
        if self.at_kw("SELECT"):
            rest = self.sql[self.peek().pos:]
            return InsertValues(name, columns, [], select_sql=rest)
        if self.at_kw("FROM"):
            raise NotPortedError("INSERT ... FROM INFILE", STORAGE)
        if self.take_kw("FORMAT") and not self.at_kw("VALUES"):
            raise NotPortedError("INSERT ... FORMAT with inline data",
                                 STORAGE)
        self.expect_kw("VALUES")
        rows = []
        while self.take_punct("("):
            row = [self.parse_insert_value()]
            while self.take_punct(","):
                row.append(self.parse_insert_value())
            self.expect_punct(")")
            rows.append(tuple(row))
            if not self.take_punct(","):
                break
        return InsertValues(name, columns, rows)

    def parse_insert_value(self):
        from myscaledb_tpu_torch.sql.ast import Literal, VectorLiteral, \
            UnOp, FuncCall
        e = self.parse_expr()
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, VectorLiteral):
            return list(e.values)
        if isinstance(e, UnOp) and e.op == "-" and \
                isinstance(e.operand, Literal):
            return -e.operand.value
        if isinstance(e, FuncCall) and e.name == "array" and \
                all(isinstance(a, Literal) for a in e.args):
            return [a.value for a in e.args]
        raise ParseError("INSERT VALUES must be literals")

    def _take_if_not_exists(self) -> bool:
        if self.take_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _take_if_exists(self) -> bool:
        if self.take_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def parse_drop(self):
        self.expect_kw("DROP")
        if self.take_kw("VECTOR"):
            # DROP VECTOR INDEX [IF EXISTS] name ON table
            self.expect_kw("INDEX")
            self._take_if_exists()
            name = self.next().text
            self.expect_kw("ON")
            return DropVectorIndex(self.parse_table_name(), name)
        if self.take_kw("INDEX"):
            # DROP INDEX [IF EXISTS] name ON table (skip index)
            self._take_if_exists()
            name = self.next().text
            self.expect_kw("ON")
            return DropSkipIndex(self.parse_table_name(), name)
        for kw in ("USER", "ROLE", "QUOTA"):
            if self.take_kw(kw):
                ie = self._take_if_exists()
                return DropPrincipal(kw.lower(), self.next().text, ie)
        if self.take_kw("ROW"):
            self.expect_kw("POLICY")
            self._take_if_exists()
            name = self.next().text
            self.expect_kw("ON")
            return DropRowPolicy(name, self.parse_table_name())
        if self.take_kw("DICTIONARY"):
            ie = self._take_if_exists()
            return DropDictionary(self.parse_table_name(), ie)
        self.expect_kw("TABLE")
        ie = self._take_if_exists()
        name = self.parse_table_name()
        self.take_kw("SYNC")
        return DropTable(name, ie)

    def parse_set(self):
        # SET name = value (a following ", name = value" is ignored, as in
        # the JAX package)
        self.expect_kw("SET")
        name = self.next().text
        self.expect_punct("=")
        t = self.next()
        if t.kind == "number":
            val = float(t.text) if "." in t.text else int(t.text)
        elif t.kind == "string":
            val = unquote_string(t.text)
        else:
            val = t.text
        return SetStatement(name, val)


# ---------------------------------------------------------------------------
# execution

MERGE_MIN_PARTS = 8

# engines that read or write outside the table (a later slice); every other
# engine keeps a plain resident table, Join and Set tables with the keys
# joinGet() and ``x IN set_table`` probe
_SPECIAL_ENGINES = {"filelog": STORAGE, "kafka": STORAGE,
                    "rabbitmq": STORAGE, "nats": STORAGE, "s3": STORAGE,
                    "file": STORAGE, "url": STORAGE}


def maybe_schedule_background_merge(session, name: str) -> None:
    """Schedule a background part merge once a table holds enough INSERT
    parts (reference: StorageMergeTree::scheduleDataProcessingJob).  The
    merge applies the table's row TTL (the reference runs
    TTLDeleteAlgorithm inside any merge) and collapses the logical part
    list; SYSTEM STOP MERGES holds it off (the JAX package accepts STOP
    MERGES and merges all the same)."""
    parts = session._table_parts.get(name)
    if parts is None or len(parts) < MERGE_MIN_PARTS:
        return
    if name in session._merges_stopped or None in session._merges_stopped:
        return
    pending = session._bg_merge_pending
    if name in pending:
        return
    pending.add(name)

    def _merge():
        try:
            if name not in session.tables:
                return
            apply_table_ttl(session, name)
            plist = session._table_parts.get(name)
            if plist is not None and len(plist) >= 2:
                total = session.tables[name].n_rows
                plist[:] = [total] if total else []
        finally:
            pending.discard(name)

    from myscaledb_tpu_torch.storage.background import default_executor
    default_executor().schedule(_merge)


def apply_table_ttl(session, name: str) -> int:
    """Delete the rows whose TTL time has passed (reference:
    TTLDeleteAlgorithm, applied here at OPTIMIZE and merge time); returns
    the number of rows removed.  A Date TTL compares in days.  A NULL TTL
    keeps its row.  If another statement replaced the table while the
    TTL was evaluated (a background merge runs beside statements), the
    table is left alone: the next merge or OPTIMIZE applies it."""
    from myscaledb_tpu_torch.exec.expr import Env, eval_expr
    from myscaledb_tpu_torch.ops.filter import compact_table_host
    ttl = session._table_ttls.get(name)
    if ttl is None:
        return 0
    t = session.tables[name]
    if t.n_rows == 0:
        return 0
    v = eval_expr(ttl, Env(t, device=session.device))
    data = v.data.expand(t.n_rows) if v.is_scalar else v.data
    now = time.time()
    if v.dt is DataType.DATE:
        now = now / 86400.0
    expired = data.to(torch.float64) <= now
    if v.valid is not None:
        expired = expired & v.valid             # NULL TTL -> keep
    n_exp = int(expired.sum())
    if n_exp == 0:
        return 0
    kept, _ = compact_table_host(t, ~expired)
    kept.name = name
    if session.tables.get(name) is not t:
        return 0
    session.tables[name] = kept
    session.bump_epoch()
    return n_exp


def _cluster_by_partition(new: Table, pkeys: list) -> Table:
    """An INSERT batch ordered by its partition key, stably, so that each
    zone-map block covers few partitions (PartitionPruner.h realized
    through the zone maps): the order of the JAX package's ``np.lexsort``
    over the keys' stored values (a String key's dictionary ids), from
    stable sorts on the batch's device, the last key first.  A batch
    already in order is kept as it is."""
    dev = next(iter(new.columns.values())).data.device
    perm = torch.arange(new.n_rows, device=dev)
    for k in reversed(pkeys):
        key = new[k].data
        if isinstance(key, np.ndarray):
            key = to_tensor(key, dev)
        perm = perm[torch.sort(key[perm], stable=True).indices]
    if bool((perm == torch.arange(new.n_rows, device=dev)).all()):
        return new
    return new.take(perm)


def _rebuild_zone_maps(table: Table) -> None:
    """Zone maps of every plain numeric or String column, taken after a
    partitioned INSERT so that partition pruning sees the new rows (the
    reference derives each part's partition minmax on write).  Per-block
    minima and maxima are taken on the device; only they reach the host."""
    from myscaledb_tpu_torch.core.table import ZoneMap
    for c in table.columns.values():
        if c.offsets is not None or c.data.ndim != 1 or not (
                c.dtype.is_numeric or c.dictionary is not None):
            continue
        host_dtype = np.int32 if c.dictionary is not None \
            else physical_dtype(c.dtype)
        c.zonemap = ZoneMap.build(np.asarray(c.data, dtype=host_dtype)) \
            if c.is_host else ZoneMap.build_device(c.data, host_dtype)


def _table_settings(raw: dict) -> TableSettings:
    """CREATE TABLE ... SETTINGS: every key TableSettings knows, typed as
    its default; other keys (the goldens' index_granularity and vector
    index build thresholds: a table here is one resident part and a build
    covers every row) are accepted and dropped."""
    ts = TableSettings()
    for f in fields(TableSettings):
        if f.name not in raw:
            continue
        v = raw[f.name]
        cur = getattr(ts, f.name)
        if isinstance(cur, bool):
            v = str(v).lower() in ("1", "true")
        elif isinstance(cur, int):
            v = int(v)
        setattr(ts, f.name, v)
    return ts


def empty_table_from_defs(name: str, defs: list, device) -> Table:
    cols = []
    for d in defs:
        offsets = None
        if d.dtype is DataType.FLOAT32_VECTOR:
            data = torch.zeros((0, max(d.vector_dim, 0)),
                               dtype=torch.float32, device=device)
        elif d.dtype is DataType.ARRAY:
            ed = d.elem or DataType.INT64
            data = torch.zeros((0,), dtype=torch.int64 if ed is
                               DataType.STRING
                               else torch_dtype(physical_dtype(ed)),
                               device=device)
            offsets = np.zeros(1, dtype=np.int64)
        else:
            data = torch.zeros((0,), dtype=torch_dtype(
                physical_dtype(d.dtype)), device=device)
        dictionary = StringDictionary() if d.dtype is DataType.STRING or (
            d.dtype is DataType.ARRAY and d.elem is DataType.STRING) else None
        is_str = d.dtype is DataType.STRING
        cols.append(Column(Field(d.name, d.dtype, d.nullable,
                                 0 if is_str else d.vector_dim, d.elem,
                                 fixed_len=d.vector_dim if is_str else 0),
                           data, None, dictionary, None, offsets))
    return Table(cols, name=name)


def _default_column(tmpl: Column, n: int, device) -> Column:
    """n rows of the column type's default value (0 / '' / []), matching
    the template's shape — the AddingDefaultsTransform analog for
    column-subset INSERTs."""
    dt = tmpl.dtype
    if dt is DataType.ARRAY:
        return Column.from_pylist_of_lists(tmpl.name, [[] for _ in range(n)],
                                           tmpl.field.elem, device=device)
    if dt is DataType.STRING:
        fill = "\x00" * tmpl.field.fixed_len if tmpl.field.fixed_len else ""
        col = Column.from_numpy(tmpl.name,
                                np.asarray([fill] * n, dtype=object),
                                DataType.STRING, device=device)
        if tmpl.field.fixed_len:
            col.field = Field(tmpl.name, DataType.STRING, col.field.nullable,
                              fixed_len=tmpl.field.fixed_len)
        return col
    if dt is DataType.FLOAT32_VECTOR:
        dim = tmpl.field.vector_dim or 1
        # defaulted vectors are masked like []-rows
        return Column(Field(tmpl.name, dt, vector_dim=dim),
                      torch.zeros((n, dim), dtype=torch.float32,
                                  device=device),
                      torch.zeros(n, dtype=torch.bool, device=device))
    arr = np.zeros(n, dtype=physical_dtype(dt))
    return Column.from_numpy(tmpl.name, arr, dt, device=device)


def rows_to_table(template: Table, columns: Optional[list], rows: list,
                  device) -> Table:
    names = columns or template.column_names
    if rows and len(rows[0]) != len(names):
        raise ParseError(f"INSERT arity mismatch: {len(rows[0])} values for "
                         f"{len(names)} columns")
    data = {}
    for i, cname in enumerate(names):
        c = template[cname]
        vals = [r[i] for r in rows]
        if c.dtype is DataType.ARRAY:
            data[cname] = Column.from_pylist_of_lists(
                cname, [list(v) for v in vals],
                None if c.field.elem is DataType.STRING else c.field.elem,
                device=device)
            continue
        if c.dtype is DataType.FLOAT32_VECTOR:
            arr = np.asarray(vals, dtype=np.float32)
            if c.field.vector_dim and arr.shape[1] != c.field.vector_dim:
                raise ParseError(
                    f"vector dim {arr.shape[1]} != declared "
                    f"{c.field.vector_dim} for column {cname!r}")
        elif c.dtype is DataType.STRING:
            fl = c.field.fixed_len
            if fl:
                # FixedString(N): pad short values with NULs, reject longer
                padded = []
                for v in vals:
                    v = "" if v is None else str(v)
                    if len(v) > fl:
                        raise ParseError(
                            f"Too large value for FixedString({fl}) "
                            f"column {cname!r}")
                    padded.append(v + "\x00" * (fl - len(v)))
                col = Column.from_numpy(cname,
                                        np.asarray(padded, dtype=object),
                                        DataType.STRING, device=device)
                col.field = Field(cname, DataType.STRING,
                                  col.field.nullable, fixed_len=fl)
                data[cname] = col
                continue
            arr = np.asarray(vals, dtype=object)
        elif c.dtype in (DataType.DATE, DataType.DATETIME):
            from myscaledb_tpu_torch.exec.datetime_fns import \
                parse_date_literal
            arr = np.asarray([parse_date_literal(v, c.dtype)
                              if isinstance(v, str) else v for v in vals]
                             ).astype(physical_dtype(c.dtype))
        else:
            if any(v is None for v in vals):
                # NULLs into a Nullable numeric column -> validity mask
                valid = np.asarray([v is not None for v in vals])
                arr = np.asarray([0 if v is None else v for v in vals]
                                 ).astype(physical_dtype(c.dtype))
                data[cname] = Column(Field(cname, c.dtype, True),
                                     to_tensor(arr, device),
                                     to_tensor(valid, device))
                continue
            arr = np.asarray(vals).astype(physical_dtype(c.dtype))
        data[cname] = arr
    dtypes = {cname: template[cname].dtype for cname in names}
    return Table.from_dict(data, dtypes=dtypes, device=device)


def _vector_from_array(tgt: Column, src: Column) -> Optional[Column]:
    """INSERT ... SELECT [a, b, c] into an Array(Float32) column: arrays of
    one uniform length become dense vectors; with a known target dim, rows
    of another length (``[]`` included) become zero rows with valid=False,
    which searches skip (the reference stores the raw Array and its
    brute-force search skips rows whose length mismatches, with
    enforce_fixed_vector_length_constraint=0).  Device ops throughout."""
    lens = np.diff(np.asarray(src.offsets))
    if len(lens) and (lens == lens[0]).all() and lens[0] > 0:
        dim = int(lens[0])
        return Column(Field(tgt.name, DataType.FLOAT32_VECTOR,
                            vector_dim=dim),
                      src.data.to(torch.float32).reshape(-1, dim))
    tdim = tgt.field.vector_dim or (
        int(tgt.data.shape[1]) if tgt.data.dim() == 2 else 0)
    if not (len(lens) and tdim):
        return None
    dev = src.data.device
    ok = lens == tdim
    dense = torch.zeros((len(lens), tdim), dtype=torch.float32, device=dev)
    rows = np.flatnonzero(ok)
    if len(rows):
        off = np.asarray(src.offsets)
        idx = off[rows][:, None] + np.arange(tdim, dtype=np.int64)
        dense[torch.as_tensor(rows, device=dev)] = src.data.to(
            torch.float32)[torch.as_tensor(idx, device=dev)]
    return Column(Field(tgt.name, DataType.FLOAT32_VECTOR, vector_dim=tdim),
                  dense, torch.as_tensor(ok, device=dev))


MV_BLOCK = "system.__mv_block"


def _view_on_block(session, mv: dict, block: Table) -> Table:
    """One materialized view's SELECT over an inserted block: the block
    stands in for the FROM table under a hidden name, read with the
    current user's SELECT privilege and row policies on the source and
    with the source's table settings.  The source table stays registered
    as it is (the JAX package swaps it for the block), so a background
    merge or the source's derived state never sees the block."""
    from dataclasses import replace
    from myscaledb_tpu_torch.runtime.memory import query_scope
    from myscaledb_tpu_torch.sql.executor import execute_any
    from myscaledb_tpu_torch.sql.parser import parse_sql
    q = parse_sql(mv["sql"])
    q = replace(q, table=MV_BLOCK, table_alias=q.table_alias or q.table)
    # a Table of its own: checked_read hands back the caller's table when
    # no row policy applies, and that table must keep its name
    blk = Table(list(session.checked_read(mv["source"], block)
                     .columns.values()), name=MV_BLOCK)
    saved = session.tables.get(MV_BLOCK)
    session.tables[MV_BLOCK] = blk
    # the source's settings (its vector metric) hold for its block
    ts = session.table_settings.get(mv["source"])
    if ts is not None:
        session.table_settings[MV_BLOCK] = ts
    try:
        with query_scope(session.settings.max_memory_bytes_per_query):
            return execute_any(session, q)
    finally:
        session.table_settings.pop(MV_BLOCK, None)
        if saved is None:
            session.tables.pop(MV_BLOCK, None)
        else:
            session.tables[MV_BLOCK] = saved


def run_materialized_views(session, table_name: str, block: Table,
                           only: Optional[dict] = None) -> None:
    """Feed an inserted block through every materialized view on the
    source table and append the rows it gives to the view's table
    (reference: buildPushingToViewsChain — views see the inserted block
    only, never re-read the source).  A TO table whose column names the
    view's do not cover takes the view's columns by position.  As in the
    JAX package the rows are appended as they are: no part is counted and
    no view on the target runs."""
    mvs = [only] if only is not None else \
        list(session.materialized_views.values())
    for mv in mvs:
        if mv["source"] != table_name or block.n_rows == 0:
            continue
        delta = _view_on_block(session, mv, block)
        tgt = session.tables.get(mv["target"])
        if tgt is not None and not set(tgt.column_names) <= \
                set(delta.column_names):
            delta = Table([Column(Field(tf.name, sc.dtype,
                                        sc.field.nullable,
                                        sc.field.vector_dim, sc.field.elem),
                                  sc.data, sc.valid, sc.dictionary, None,
                                  sc.offsets)
                           for tf, sc in zip(tgt.columns.values(),
                                             delta.columns.values())])
        if tgt is None or tgt.n_rows == 0:
            merged = delta if tgt is None else delta.select(tgt.column_names)
        else:
            merged = concat_tables([tgt, delta.select(tgt.column_names)])
        merged.name = mv["target"]
        session.tables[mv["target"]] = merged


def _create_view(session, stmt: CreateView) -> None:
    if not stmt.materialized:
        if stmt.name in session.views and stmt.if_not_exists:
            return
        session.views[stmt.name] = stmt.select_sql
        return
    # StorageMaterializedView: the SELECT runs over each inserted block of
    # its source; its rows go to the TO table or to a table of its own
    from myscaledb_tpu_torch.sql.parser import parse_sql
    if stmt.name in session.materialized_views and stmt.if_not_exists:
        return
    src = getattr(parse_sql(stmt.select_sql), "table", None)
    if src is None or src not in session.tables:
        raise ValueError("MATERIALIZED VIEW requires FROM <registered "
                         "table>")
    target = stmt.to_table or stmt.name
    mv = {"source": src, "sql": stmt.select_sql, "target": target}
    if stmt.to_table is None:
        # the view's own table: its schema from the SELECT over no rows,
        # then POPULATE's rows
        src_t = session.tables[src]
        t0 = _view_on_block(session, mv, src_t if stmt.populate
                            else src_t.head(0))
        t0.name = target
        session.tables[target] = t0
    elif stmt.populate:
        run_materialized_views(session, src, session.tables[src], only=mv)
    session.materialized_views[stmt.name] = mv


def _build_dictionary(session, stmt: CreateDictionary):
    """Snapshot a table into a Dictionary on the session's device
    (reference: ExternalDictionariesLoader; LIFETIME is a snapshot)."""
    from myscaledb_tpu_torch.runtime.dictionaries import Dictionary
    if stmt.source_kind == "file":
        raise NotPortedError("CREATE DICTIONARY ... SOURCE(FILE(...))",
                             STORAGE)
    src = session.get_table(stmt.source_arg).select(
        [d.name for d in stmt.columns])
    d = Dictionary(stmt.name, src, stmt.primary_key, stmt.layout,
                   f"{stmt.source_kind}:{stmt.source_arg}")
    d.spec = stmt
    return d


def _rebuild_zone_map(col: Column, old: Column) -> Column:
    """``col``, the new values of ``old``, with a zone map taken anew where
    ``old`` had one (a mutation moved its values)."""
    from myscaledb_tpu_torch.core.table import ZoneMap
    if old.zonemap is not None and not col.is_host:
        host_dtype = np.int32 if col.dictionary is not None \
            else physical_dtype(col.dtype)
        col.zonemap = ZoneMap.build_device(col.data, host_dtype)
    return col


def _alter_update(session, stmt: AlterUpdate) -> int:
    """ALTER TABLE t UPDATE c = expr, ... WHERE cond: every assignment is
    evaluated over the table as it was and written where cond holds,
    with one where() per column on the device; the updated columns' zone
    maps are taken anew.  A String value is encoded into the column's
    dictionary.  Returns the rows changed."""
    from myscaledb_tpu_torch.exec.expr import Env, eval_expr, as_bool_mask
    t = session.tables[stmt.table]
    env = Env(t, device=session.device)
    cond = as_bool_mask(eval_expr(stmt.where, env), t.n_rows)
    cols = dict(t.columns)
    for name, expr in stmt.assignments:
        old = t[name]
        v = eval_expr(expr, env)
        if old.dictionary is not None:
            if v.is_scalar:
                new = torch.full((), old.dictionary.encode_one(
                    "" if v.py is None else str(v.py), grow=True),
                    dtype=old.data.dtype, device=old.data.device)
            else:
                if v.dictionary is None:
                    raise ValueError(f"cannot assign a number to String "
                                     f"column {name!r}")
                lut = to_tensor(np.append(old.dictionary.merge_from(
                    v.dictionary), -1).astype(np.int64), old.data.device)
                new = lut[v.data.long()].to(old.data.dtype)
        else:
            new = v.data.to(old.data.dtype)
        data = torch.where(cond, new, old.data)
        cols[name] = _rebuild_zone_map(Column(old.field, data, old.valid,
                                              old.dictionary), old)
    nt = Table(list(cols.values()), name=stmt.table)
    session.tables[stmt.table] = nt
    return int(cond.sum())


def _new_column(t: Table, name: str, type_tokens, default, device) -> Column:
    """ADD COLUMN's values: the DEFAULT expression over every row, cast to
    the declared type (ClickHouse's; the JAX package keeps the
    expression's type), or the type's default value."""
    from myscaledb_tpu_torch.exec.expr import Env, eval_expr
    from myscaledb_tpu_torch.sql.executor import _value_to_column
    dtype, nullable, vdim, elem = type_tokens
    tmpl = empty_table_from_defs("", [ColumnDef(name, dtype, nullable, vdim,
                                                elem)], device)[name]
    if default is None:
        return _default_column(tmpl, t.n_rows, device)
    col = _value_to_column(name, eval_expr(default, Env(t, device=device)),
                           t.n_rows, device)
    return _cast_column(col, tmpl)


def _cast_column(col: Column, tmpl: Column) -> Column:
    """col's values as tmpl's type: numbers and dates cast on the device,
    Strings kept with their dictionary (a number into a String and a
    String into a number are refused)."""
    if (col.dictionary is None) != (tmpl.dictionary is None) or \
            col.offsets is not None or tmpl.offsets is not None or \
            col.data.dim() != 1:
        if col.dtype is tmpl.dtype:
            return col
        raise ValueError(f"cannot convert column {col.name!r} from "
                         f"{col.dtype.name} to {tmpl.dtype.name}")
    data = col.data if col.dictionary is not None else \
        col.data.to(tmpl.data.dtype)
    valid = col.valid if tmpl.field.nullable else None
    return Column(tmpl.field, data, valid, col.dictionary)


def required_privilege(stmt):
    """(privilege, target) the current user must hold to run stmt, or None
    (reference: InterpreterFactory + ContextAccess::checkAccess)."""
    if isinstance(stmt, ACCESS_STATEMENTS):
        return ("ACCESS MANAGEMENT", "*")
    if isinstance(stmt, InsertValues):
        return ("INSERT", stmt.table)
    if isinstance(stmt, (CreateTable, CreateDictionary, CreateView)):
        return ("CREATE TABLE", stmt.name)
    if isinstance(stmt, (DropTable, DropDictionary)):
        return ("DROP", stmt.name)
    if isinstance(stmt, TruncateTable):
        return ("TRUNCATE", stmt.name)
    if isinstance(stmt, (AlterDelete, AlterUpdate, AddVectorIndex,
                         DropVectorIndex, DropPartition, AddSkipIndex,
                         DropSkipIndex, ModifyTableSetting, ModifyColumn,
                         AddProjection, DropProjection, AlterMulti,
                         AddConstraint, DropConstraint, AddColumn,
                         DropColumn, MaterializeColumn)):
        return ("ALTER", stmt.table)
    if isinstance(stmt, OptimizeTable):
        return ("OPTIMIZE", stmt.table)
    return None


def _vi_event(session, table: str, index: str, kind: str, **extra) -> None:
    # lifecycle events (reference: VIEventLog event enum)
    session.vi_events.append({"event_time": time.time(), "table": table,
                              "index_name": index, "event_type": kind,
                              **extra})


def _add_vector_index(session, stmt: AddVectorIndex) -> None:
    if stmt.table not in session.tables:
        raise ValueError(f"unknown table {stmt.table!r}")
    t = session.tables[stmt.table]
    if stmt.column not in t or not t[stmt.column].dtype.is_vector:
        raise ValueError(f"{stmt.column!r} is not a vector column")
    # metric from params ('metric_type=L2') overrides table settings
    params = {}
    for kv in stmt.params.replace("'", "").replace('"', "").split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            params[k.strip().lower()] = v.strip()
    with session.vi_lock:
        idxs = session.vector_indices
        # duplicate declarations mirror the reference's checks
        # (MergeTreeData::checkVectorIndexes): same name -> LOGICAL_ERROR,
        # second index on one column -> NOT_IMPLEMENTED
        for i in idxs:
            if i["table"] == stmt.table and i["name"] == stmt.name:
                if stmt.if_not_exists:
                    return
                raise ValueError(
                    f"DB::Exception: vector index {stmt.name!r} already "
                    f"exists on table {stmt.table!r}")
            if i["table"] == stmt.table and i["column"] == stmt.column:
                raise ValueError(
                    "DB::Exception: NOT_IMPLEMENTED: only one vector index "
                    "per column is supported")
        if "metric_type" in params:
            ts = session.table_settings.setdefault(stmt.table,
                                                   TableSettings())
            # normalize spellings: the suite writes 'cosine'/'l2'/'ip'
            mt = params["metric_type"]
            ts.float_vector_search_metric_type = {
                "cosine": "Cosine", "l2": "L2", "ip": "IP"}.get(
                mt.lower(), mt)
        entry = {"table": stmt.table, "name": stmt.name,
                 "column": stmt.column, "type": stmt.index_type,
                 "status": "InProgress", "params": stmt.params}
        idxs.append(entry)
    for ev in ("DEFINITION_CREATED", "BUILD_START"):
        _vi_event(session, stmt.table, stmt.name, ev)
    # the statement moves the epoch now, so the artifact it builds is the
    # one the next query reads (the driver does not move it again)
    session.bump_epoch()

    def _build(table_name=stmt.table, col=stmt.column, e=entry):
        # the scan artifact (squared norms + SQ8 sidecar) of the current
        # epoch; a query arriving first builds it lazily, and the sidecar
        # lock hands one build to both
        from myscaledb_tpu_torch.sql.executor import _vector_sidecar
        try:
            epoch = session._mutation_epoch      # before the table: a later
            t_now = session.tables.get(table_name)   # epoch only re-builds
            if t_now is not None and t_now.n_rows > 0:
                _vector_sidecar(session, table_name, t_now, col, epoch=epoch)
            with session.vi_lock:
                e["status"] = "Built"
            _vi_event(session, table_name, e["name"], "BUILD_SUCCEED")
        except Exception as err:       # noqa: BLE001
            with session.vi_lock:
                e["status"] = "Error"
            _vi_event(session, table_name, e["name"], "BUILD_ERROR",
                      error=str(err)[:200])

    if t.n_rows < BACKGROUND_BUILD_ROWS:
        # small build: inline, so the status a follow-up query sees is
        # deterministic
        _build()
    else:
        from myscaledb_tpu_torch.storage.background import default_executor
        default_executor().schedule(_build)


def _insert_select(session, stmt: InsertValues, existing: Table) -> Table:
    new = session.sql(stmt.select_sql)
    if stmt.columns:
        new = new.select(stmt.columns)
    # align column names to the target schema by position
    renamed = []
    for tgt, src in zip(existing.columns.values(), new.columns.values()):
        if tgt.dtype is DataType.FLOAT32_VECTOR and src.offsets is not None:
            col = _vector_from_array(tgt, src)
            if col is not None:
                renamed.append(col)
                continue
        renamed.append(Column(Field(tgt.name, src.dtype, src.field.nullable,
                                    src.field.vector_dim, src.field.elem,
                                    fixed_len=tgt.field.fixed_len),
                              src.data, src.valid, src.dictionary, None,
                              src.offsets))
    return Table(renamed)


def execute_statement(session, stmt) -> Table:
    dev = session.device
    empty = Table([])

    if isinstance(stmt, CreateTable):
        if stmt.name in session.tables:
            if stmt.if_not_exists:
                return empty
            raise ValueError(f"table {stmt.name!r} already exists")
        slice_name = _SPECIAL_ENGINES.get(stmt.engine.lower())
        if slice_name is not None:
            raise NotPortedError(f"ENGINE = {stmt.engine}", slice_name)
        t = empty_table_from_defs(stmt.name, stmt.columns, dev)
        session.register(stmt.name, t, _table_settings(stmt.settings))
        session._table_order_keys[stmt.name] = stmt.order_by
        session._table_partition_keys[stmt.name] = stmt.partition_by
        if stmt.ttl is not None:
            session._table_ttls[stmt.name] = stmt.ttl
        if stmt.skip_indexes:
            session._table_skip_indexes[stmt.name] = list(stmt.skip_indexes)
        eng = stmt.engine.lower()
        if eng == "join":
            # StorageJoin: the table body is the build side joinGet()
            # probes; it still joins and scans as an ordinary table
            if len(stmt.engine_args) < 3:
                raise ValueError(
                    "ENGINE = Join needs (strictness, kind, keys...)")
            session._table_engines[stmt.name] = {
                "engine": "Join",
                "strictness": stmt.engine_args[0].upper(),
                "kind": stmt.engine_args[1].upper(),
                "keys": [a.strip() for a in stmt.engine_args[2:]]}
        elif eng == "set":
            # StorageSet: ``x IN set_table`` reads its rows
            session._table_engines[stmt.name] = {"engine": "Set"}
        for vname, vcol, vtype, vparams in stmt.vector_indexes:
            _add_vector_index(session, AddVectorIndex(
                stmt.name, vname, vcol, vtype, vparams))
        return empty

    if isinstance(stmt, AddSkipIndex):
        if stmt.table not in session.tables:
            raise ValueError(f"unknown table {stmt.table!r}")
        defs = [i for i in session._table_skip_indexes.get(stmt.table, ())
                if i.name != stmt.index.name]
        session._table_skip_indexes[stmt.table] = defs + [stmt.index]
        return empty

    if isinstance(stmt, DropSkipIndex):
        if stmt.table in session._table_skip_indexes:
            session._table_skip_indexes[stmt.table] = [
                i for i in session._table_skip_indexes[stmt.table]
                if i.name != stmt.name]
        return empty

    if isinstance(stmt, AlterMulti):
        for cmd in stmt.commands:
            execute_statement(session, cmd)
        return empty

    if isinstance(stmt, AddConstraint):
        if stmt.table not in session.tables:
            raise ValueError(f"unknown table {stmt.table!r}")
        session._table_constraints.setdefault(stmt.table, {})[stmt.name] = \
            stmt.expr
        return empty

    if isinstance(stmt, DropConstraint):
        session._table_constraints.get(stmt.table, {}).pop(stmt.name, None)
        return empty

    if isinstance(stmt, (MaterializeColumn, AlterUpdate, AddColumn,
                         DropColumn, ModifyColumn, ModifyTableSetting,
                         AddProjection)) and \
            stmt.table not in session.tables:
        raise ValueError(f"unknown table {stmt.table!r}")

    if isinstance(stmt, MaterializeColumn):
        return empty        # ADD COLUMN materialized the values already

    if isinstance(stmt, AlterUpdate):
        _alter_update(session, stmt)
        return empty

    if isinstance(stmt, AddColumn):
        t = session.tables[stmt.table]
        if stmt.name in t.column_names:
            if stmt.if_not_exists:
                return empty
            raise ValueError(f"column {stmt.name!r} already exists")
        col = _new_column(t, stmt.name, stmt.type_tokens, stmt.default, dev)
        session.tables[stmt.table] = Table(list(t.columns.values()) + [col],
                                           name=stmt.table)
        return empty

    if isinstance(stmt, DropColumn):
        t = session.tables[stmt.table]
        if stmt.name not in t.column_names:
            raise ValueError(f"unknown column {stmt.name!r}")
        session.tables[stmt.table] = t.select(
            [c for c in t.column_names if c != stmt.name])
        return empty

    if isinstance(stmt, ModifyColumn):
        t = session.tables[stmt.table]
        if stmt.name not in t.column_names:
            raise ValueError(f"unknown column {stmt.name!r}")
        tmpl = empty_table_from_defs("", [ColumnDef(stmt.name,
                                                    *stmt.type_tokens)],
                                     dev)[stmt.name]
        cols = [_rebuild_zone_map(_cast_column(c, tmpl), c)
                if c.name == stmt.name else c for c in t.columns.values()]
        session.tables[stmt.table] = Table(cols, name=stmt.table)
        return empty

    if isinstance(stmt, ModifyTableSetting):
        ts = session.table_settings.setdefault(stmt.table, TableSettings())
        val = stmt.value
        if isinstance(val, str) and \
                stmt.name == "binary_vector_search_metric_type":
            val = val.capitalize()          # HAMMING/Jaccard spellings
        # unknown settings are recorded, like the reference's free-form
        # MergeTreeSettings
        setattr(ts, stmt.name, val)
        return empty

    if isinstance(stmt, AddProjection):
        from myscaledb_tpu_torch.sql.optimizer import parse_projection
        session._projections.setdefault(stmt.table, {})[stmt.name] = \
            parse_projection(stmt.name, stmt.select_sql)
        return empty

    if isinstance(stmt, DropProjection):
        session._projections.get(stmt.table, {}).pop(stmt.name, None)
        return empty

    if isinstance(stmt, InsertValues):
        if stmt.table not in session.tables:
            raise ValueError(f"unknown table {stmt.table!r}")
        existing = session.tables[stmt.table]
        if stmt.select_sql is not None:
            new = _insert_select(session, stmt, existing)
        else:
            new = rows_to_table(existing, stmt.columns, stmt.rows, dev)
        pkeys = session._table_partition_keys.get(stmt.table) or []
        if pkeys and all(k in new for k in pkeys) and new.n_rows > 1:
            new = _cluster_by_partition(new, pkeys)
        if existing.n_rows == 0 and set(new.column_names) == \
                set(existing.column_names):
            # first insert fixes unknown vector dims
            merged = new.select(existing.column_names)
        else:
            missing = [n for n in existing.column_names
                       if n not in new.column_names]
            if missing and new.n_rows:
                # column-subset INSERT: absent columns take their type
                # default (reference: AddingDefaultsTransform)
                new = Table(list(new.columns.values()) +
                            [_default_column(existing[n], new.n_rows, dev)
                             for n in missing])
            merged = concat_tables([existing, new.select(
                existing.column_names)])
        merged.name = stmt.table
        if pkeys:
            _rebuild_zone_maps(merged)
        session.tables[stmt.table] = merged
        # logical part accounting for system.parts (one part per INSERT
        # batch until a merge collapses them — MergeTreeData part model)
        session._table_parts.setdefault(stmt.table, []).append(new.n_rows)
        maybe_schedule_background_merge(session, stmt.table)
        # once per statement, over the rows as the table took them
        run_materialized_views(session, stmt.table, new)
        return empty

    if isinstance(stmt, DetachTable):
        # the table leaves the catalog but its data survives for ATTACH
        # (InterpreterDropQuery detach kind)
        if stmt.table not in session.tables:
            raise ValueError(f"unknown table {stmt.table!r}")
        session._detached[stmt.table] = (
            session.tables.pop(stmt.table),
            session.table_settings.pop(stmt.table, None))
        return empty

    if isinstance(stmt, AttachTable):
        if stmt.table not in session._detached:
            raise ValueError(f"no detached table {stmt.table!r}")
        tbl, ts = session._detached.pop(stmt.table)
        session.tables[stmt.table] = tbl
        if ts is not None:
            session.table_settings[stmt.table] = ts
        return empty

    if isinstance(stmt, DropPartition):
        # DROP PARTITION value deletes every row whose first partition key
        # column equals the value (MergeTreeData::dropPartition; the
        # partition here is the clustered key value)
        from myscaledb_tpu_torch.sql.ast import BinOp, Ident, Literal
        pkeys = session._table_partition_keys.get(stmt.table) or []
        if not pkeys:
            raise ValueError(f"table {stmt.table!r} is not partitioned")
        stmt = AlterDelete(stmt.table,
                           BinOp("=", Ident(pkeys[0]), Literal(stmt.value)))

    if isinstance(stmt, AlterDelete):
        # lightweight-delete semantics: rows matching WHERE disappear
        # (reference: MutateTask + _row_exists mask; the table is rewritten)
        from myscaledb_tpu_torch.exec.expr import Env, eval_expr, \
            as_bool_mask
        from myscaledb_tpu_torch.ops.filter import compact_table_host
        t = session.tables[stmt.table]
        kill = as_bool_mask(eval_expr(stmt.where, Env(t, device=dev)),
                            t.n_rows)
        keep, _ = compact_table_host(t, ~kill)
        keep.name = stmt.table
        session.tables[stmt.table] = keep
        return empty

    if isinstance(stmt, OptimizeTable):
        if stmt.table not in session.tables:
            raise ValueError(f"unknown table {stmt.table!r}")
        apply_table_ttl(session, stmt.table)
        parts = session._table_parts
        if stmt.table in parts:          # merge collapses the part set
            total = session.tables[stmt.table].n_rows
            parts[stmt.table] = [total] if total else []
        return empty

    if isinstance(stmt, AddVectorIndex):
        _add_vector_index(session, stmt)
        return empty

    if isinstance(stmt, DropVectorIndex):
        with session.vi_lock:
            session.vector_indices[:] = [
                i for i in session.vector_indices
                if not (i["table"] == stmt.table and i["name"] == stmt.name)]
        _vi_event(session, stmt.table, stmt.name, "DEFINITION_DROPPED")
        return empty

    if isinstance(stmt, DropTable):
        if stmt.name in session.views:
            del session.views[stmt.name]
            return empty
        mv = session.materialized_views.pop(stmt.name, None)
        if mv is not None:
            if mv["target"] == stmt.name:   # the view's own table
                session.drop_table(stmt.name)
            return empty
        if stmt.name not in session.tables and not stmt.if_exists:
            raise ValueError(f"unknown table {stmt.name!r}")
        session.drop_table(stmt.name)
        return empty

    if isinstance(stmt, TruncateTable):
        t = session.tables[stmt.name]
        session.tables[stmt.name] = t.head(0)
        session._table_parts.pop(stmt.name, None)
        return empty

    if isinstance(stmt, SetStatement):
        if hasattr(session.settings, stmt.name):
            cur = getattr(session.settings, stmt.name)
            val = stmt.value
            if isinstance(cur, bool):
                val = bool(int(val)) if not isinstance(val, str) else \
                    val.lower() in ("1", "true")
            elif isinstance(cur, int) and not isinstance(val, str):
                val = int(val)
            setattr(session.settings, stmt.name, val)
        # unknown settings are accepted silently (CH compat): the goldens'
        # mutations_sync, allow_experimental_lightweight_delete and
        # two_stage_search_option change nothing here, where a DELETE is
        # always synchronous and lightweight and every search is exact
        return empty

    if isinstance(stmt, SystemStatement):
        if stmt.action == "merges_stop":
            session._merges_stopped.add(stmt.target)
        elif stmt.action == "merges_start":
            session._merges_stopped.discard(stmt.target)
            if stmt.target is None:
                session._merges_stopped.clear()
            for name in ([stmt.target] if stmt.target
                         else list(session._table_parts)):
                maybe_schedule_background_merge(session, name)
        elif stmt.action == "drop_query_cache":
            session._query_cache.clear()
        elif stmt.action == "reload_dictionary":
            names = [stmt.target] if stmt.target else \
                list(session.dictionaries)
            for n in names:
                d = session.dictionaries.get(n)
                if d is None:
                    raise ValueError(f"unknown dictionary {n!r}")
                session.dictionaries[n] = _build_dictionary(session, d.spec)
        # flush_logs: the logs are live tables here
        return empty

    if isinstance(stmt, CreateView):
        _create_view(session, stmt)
        return empty

    if isinstance(stmt, CreateDictionary):
        if stmt.name in session.dictionaries and stmt.if_not_exists:
            return empty
        session.dictionaries[stmt.name] = _build_dictionary(session, stmt)
        return empty

    if isinstance(stmt, DropDictionary):
        if stmt.name not in session.dictionaries and not stmt.if_exists:
            raise ValueError(f"unknown dictionary {stmt.name!r}")
        session.dictionaries.pop(stmt.name, None)
        return empty

    if isinstance(stmt, ACCESS_STATEMENTS):
        _access_statement(session.access, stmt)
        return empty

    if isinstance(stmt, ShowGrants):
        user = stmt.user or session.current_user
        return Table.from_dict({"grants": [
            f"GRANT {p} ON {t if t != '*' else '*.*'} TO {user}"
            for p, t in sorted(session.access.effective_grants(user))]},
            device=dev)

    if isinstance(stmt, ShowAccess):
        return session.sql(
            f"SELECT name FROM system.{stmt.what} ORDER BY name")

    if isinstance(stmt, ShowTables):
        return session.sql("SELECT name FROM system.tables ORDER BY name")

    if isinstance(stmt, DescribeTable):
        t = session.get_table(stmt.name)
        flds = [f for f in t.schema() if not f.name.startswith("__")]
        return Table.from_dict({"name": [f.name for f in flds],
                                "type": [str(f).split(" ", 1)[1]
                                         for f in flds]}, device=dev)

    raise ValueError(f"unsupported statement {stmt!r}")


def _access_statement(access, stmt) -> None:
    """Users, roles, grants, row policies and quotas, kept by
    runtime/access.py."""
    from myscaledb_tpu_torch.runtime.access import Quota, RowPolicy
    if isinstance(stmt, CreateUser):
        access.create_user(stmt.name, stmt.password, stmt.if_not_exists)
    elif isinstance(stmt, CreateRole):
        access.create_role(stmt.name, stmt.if_not_exists)
    elif isinstance(stmt, DropPrincipal):
        getattr(access, f"drop_{stmt.kind}")(stmt.name, stmt.if_exists)
    elif isinstance(stmt, GrantStmt):
        if stmt.is_role:
            access.grant_role(stmt.privs, stmt.grantees)
        else:
            access.grant(stmt.privs, stmt.target, stmt.grantees)
    elif isinstance(stmt, RevokeStmt):
        if stmt.is_role:
            access.revoke_role(stmt.privs, stmt.grantees)
        else:
            access.revoke(stmt.privs, stmt.target, stmt.grantees)
    elif isinstance(stmt, CreateRowPolicy):
        access.add_row_policy(RowPolicy(
            stmt.name, stmt.table, stmt.using_expr, stmt.using_sql,
            set(stmt.to_users) if stmt.to_users is not None else None))
    elif isinstance(stmt, DropRowPolicy):
        access.drop_row_policy(stmt.name, stmt.table)
    else:
        access.add_quota(Quota(
            stmt.name, stmt.interval_s, stmt.limits,
            set(stmt.to_users) if stmt.to_users is not None else None))
