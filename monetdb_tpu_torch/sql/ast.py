"""Statement-level AST (the parser's output, pre-binding).
Expressions reuse plan.exprs nodes with unresolved ColRefs."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from ..plan.exprs import Expr

__all__ = ["SelectStmt", "TableSource", "SubquerySource", "JoinSource",
           "CreateTable", "DropTable", "InsertValues", "CopyFrom"]


@dataclasses.dataclass
class TableSource:
    name: str
    alias: str


@dataclasses.dataclass
class SubquerySource:
    select: "SelectStmt"
    alias: str
    col_aliases: Optional[List[str]] = None


@dataclasses.dataclass
class JoinSource:
    left: Any
    right: Any
    kind: str                  # inner left right full cross
    on: Optional[Expr]


@dataclasses.dataclass
class SelectStmt:
    items: List[Tuple[Optional[str], Expr]]    # (alias, expr); Star possible
    sources: List[Any]
    where: Optional[Expr] = None
    group_by: List[Expr] = dataclasses.field(default_factory=list)
    # ROLLUP/CUBE/GROUPING SETS: list of key subsets (each a list of the
    # group_by exprs); None = plain GROUP BY
    grouping_sets: Optional[List[List[Expr]]] = None
    having: Optional[Expr] = None
    order_by: List[Tuple[Expr, bool, Optional[bool]]] = \
        dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    sample: Optional[int] = None
    sample_seed: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    setops: List[Tuple[str, "SelectStmt"]] = \
        dataclasses.field(default_factory=list)
    # WITH clause (reference: sql_parser.y <with clause>; RECURSIVE is
    # rejected there too): [(name, col_aliases|None, SelectStmt), ...]
    ctes: List[Tuple[str, Optional[List[str]], "SelectStmt"]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ValuesSource:
    """(VALUES (...), (...)) [AS alias (cols)] table constructor
    (reference: sql_parser.y table_ref → values)."""
    rows: List[List[Expr]]
    alias: str
    col_aliases: Optional[List[str]] = None


@dataclasses.dataclass
class TableFuncSource:
    name: str                 # generate_series
    args: List[Expr]
    alias: str


@dataclasses.dataclass
class CreateTable:
    name: str
    columns: List[Tuple[str, Any, bool]]   # name, SQLType, not_null
    checks: Any = None   # table-level [(constraint_name|None, expr_sql)]
    uniques: Any = None  # multi-column UNIQUE sets [[col, ...], ...]
    fks: Any = None      # [[cols], rtable, [rcols]] foreign keys


@dataclasses.dataclass
class AddUniqueKey:
    """ALTER TABLE t ADD [CONSTRAINT n] {PRIMARY KEY|UNIQUE} (cols):
    validates existing data before registering (sql_cat.c ukey DDL)."""
    table: str
    cols: List[str]
    pk: bool = False


@dataclasses.dataclass
class AddForeignKey:
    """ALTER TABLE t ADD [CONSTRAINT n] FOREIGN KEY (cols) REFERENCES
    rt (rcols) (sql_cat.c ukey/fkey DDL)."""
    table: str
    cols: List[str]
    rtable: str
    rcols: List[str]
    action: str = "restrict"   # ON DELETE restrict|cascade|setnull


@dataclasses.dataclass
class CreateTableAs:
    """CREATE TABLE t [(c1, c2)] AS SELECT ... [WITH [NO] DATA]
    (rel_schema.c rel_create_table as-select form)."""
    name: str
    select: "SelectStmt"
    with_data: bool = True
    columns: Optional[List[str]] = None   # bare column-name list


@dataclasses.dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateView:
    name: str
    select_sql: str
    replace: bool = False


@dataclasses.dataclass
class DropView:
    name: str


@dataclasses.dataclass
class Call:
    """CALL proc(args) — sysmon procedures (sys.stop, sys.setquerytimeout;
    sql/scripts/26_sysmon.sql)."""
    name: str
    args: List[Expr]


@dataclasses.dataclass
class CreateSequence:
    name: str
    start: int = 1
    inc: int = 1
    minv: object = None
    maxv: object = None


@dataclasses.dataclass
class AlterSequence:
    """ALTER SEQUENCE s RESTART [WITH n] / INCREMENT BY n
    (sql_parser.y alter_statement sequence; store_sequence.c)."""
    name: str
    restart: object = None   # int | None
    inc: object = None       # int | None


@dataclasses.dataclass
class CreateSchema:
    """CREATE SCHEMA s [AUTHORIZATION owner] (sql_parser.y schema_def,
    rel_schema.c rel_create_schema)."""
    name: str
    auth: object = None
    if_not_exists: bool = False


@dataclasses.dataclass
class DropSchema:
    name: str
    if_exists: bool = False
    cascade: bool = False


@dataclasses.dataclass
class CreateIndex:
    """CREATE [UNIQUE] INDEX i ON t(cols) — advisory here: the engine's
    sort-based kernels replace persisted hash/order indexes
    (gdk_hash.c/gdk_orderidx.c 'replaced-by' rows in PARITY.md); the
    definition is kept for catalog/COMMENT parity (sql_cat.c
    create_index)."""
    name: str
    table: str
    cols: list
    unique: bool = False


@dataclasses.dataclass
class DropIndex:
    name: str


@dataclasses.dataclass
class DropSequence:
    name: str


@dataclasses.dataclass
class CreateFunction:
    """CREATE FUNCTION f(args) RETURNS t LANGUAGE PYTHON { body }
    (reference: sql/backends/monet5/UDF/pyapi3), RETURN <expr> SQL
    scalar functions, and RETURNS TABLE(...) table functions
    (rel_psm.c)."""
    name: str
    params: List[Tuple[str, Any]]   # (name, SQLType)
    ret_type: Any                    # SQLType; None for table functions
    language: str                    # python | sql | sql_table
    body: str
    cols: Any = None                 # [(name, SQLType)] for sql_table


@dataclasses.dataclass
class DropFunction:
    name: str


@dataclasses.dataclass
class CreateMergeTable:
    """CREATE MERGE TABLE name (cols) [PARTITION BY RANGE|VALUES ON (col)]
    — the reference's partitioned merge tables (sql/server/rel_schema.c,
    CREATE MERGE TABLE ... PARTITION BY)."""
    name: str
    columns: List[Tuple[str, Any, bool]]
    part_kind: Optional[str] = None        # 'range' | 'values' | None
    part_col: Optional[str] = None


@dataclasses.dataclass
class CreateRemoteTable:
    """CREATE REMOTE TABLE name (cols) ON 'host:port[/rtable]'
    (reference: rel_schema.c remote tables AT 'mapi:monetdb://...')."""
    name: str
    columns: List[Tuple[str, Any, bool]]
    addr: str


@dataclasses.dataclass
class CreateReplicaTable:
    name: str
    columns: List[Tuple[str, Any, bool]]


@dataclasses.dataclass
class AlterAddTable:
    """ALTER TABLE parent ADD TABLE member
         [AS PARTITION FROM lo TO hi | AS PARTITION IN (v,...)
          | AS PARTITION FOR NULL VALUES]"""
    parent: str
    member: str
    part_range: Optional[Tuple[Any, Any]] = None
    part_values: Optional[List[Any]] = None
    part_nulls: bool = False


@dataclasses.dataclass
class AlterDropTable:
    parent: str
    member: str


@dataclasses.dataclass
class InsertValues:
    table: str
    rows: List[List[Expr]]
    columns: Optional[List[str]] = None


@dataclasses.dataclass
class CopyFrom:
    table: str
    path: str                    # file path, or "stdin" with inline data
    delimiter: str = "|"
    records: Optional[int] = None
    quote: Optional[str] = None  # USING DELIMITERS f, r, quote
    nullstr: Optional[str] = None
    data: Optional[str] = None   # inline rows (COPY ... FROM STDIN)
    columns: Optional[List[str]] = None  # target column subset/order


@dataclasses.dataclass
class CopyInto:
    """COPY <table|select> INTO 'file' — result export (msqldump/
    mvc_export analog)."""
    source: Any               # table name str or SelectStmt
    path: str
    delimiter: str = "|"


@dataclasses.dataclass
class CopyBinaryFrom:
    """COPY BINARY INTO t FROM (files...) — fixed-width binary bulk load
    (sql/backends/monet5/sql_bincopy*.c)."""
    table: str
    paths: List[str]


@dataclasses.dataclass
class InsertSelect:
    table: str
    select: "SelectStmt"
    columns: Optional[List[str]] = None


@dataclasses.dataclass
class Delete:
    table: str
    where: Optional[Expr] = None


@dataclasses.dataclass
class Update:
    table: str
    sets: List[Tuple[str, Expr]] = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None


@dataclasses.dataclass
class MergeStmt:
    """MERGE INTO target USING source ON cond WHEN [NOT] MATCHED THEN ...
    (sql_parser.y merge_stmt; planned in rel_updates.c merge plans)."""
    target: str
    target_alias: str
    source: Any                      # table name str or SelectStmt
    source_alias: str
    on: Expr
    matched: Optional[Any] = None    # ("update", sets) | ("delete",)
    not_matched: Optional[Any] = None  # (cols|None, [Expr, ...])


@dataclasses.dataclass
class TxnStmt:
    kind: str          # begin / commit / rollback


@dataclasses.dataclass
class Truncate:
    """TRUNCATE [TABLE] t (reference: sql_parser.y truncate_statement,
    rel_updates.c rel_truncate)."""
    table: str


@dataclasses.dataclass
class AlterAddColumn:
    """ALTER TABLE t ADD [COLUMN] c type [constraints] (sql_cat.c
    sql_alter_table / rel_schema.c)."""
    table: str
    column: str
    ctype: Any
    flags: dict


@dataclasses.dataclass
class AlterDropColumn:
    table: str
    column: str


@dataclasses.dataclass
class AlterRenameTable:
    table: str
    new_name: str


@dataclasses.dataclass
class AlterRenameSchema:
    schema: str
    new_name: str
    if_exists: bool = False


@dataclasses.dataclass
class AlterSetSchema:
    table: str
    new_schema: str


@dataclasses.dataclass
class AlterRenameColumn:
    table: str
    column: str
    new_name: str


@dataclasses.dataclass
class CreateTrigger:
    """CREATE TRIGGER name {BEFORE|AFTER} {INSERT|UPDATE|DELETE} ON t
    <statement> — statement-level triggers (sql_parser.y trigger_def,
    rel_schema.c create_trigger; the reference also supports row-level
    via FOR EACH ROW, here statement-level only)."""
    name: str
    time: str            # before | after
    event: str           # insert | update | delete
    table: str
    body_sql: str        # statements, ';'-separated
    replace: bool = False


@dataclasses.dataclass
class DropTrigger:
    name: str


@dataclasses.dataclass
class CreateProcedure:
    """CREATE PROCEDURE name(params) BEGIN stmt; ... END (rel_psm.c)."""
    name: str
    params: List[Tuple[str, Any]]
    body_sql: str


@dataclasses.dataclass
class DropProcedure:
    name: str


@dataclasses.dataclass
class CommentOn:
    """COMMENT ON TABLE|COLUMN|VIEW ... IS 'text' (sql_parser.y comment_on,
    stored in sys.comments)."""
    kind: str            # table | column | view | function
    target: str          # table or table.column
    text: Optional[str]  # None = remove


@dataclasses.dataclass
class AlterSetAccess:
    """ALTER TABLE t SET {READ ONLY|INSERT ONLY|READ WRITE}
    (sql_cat.c sql_alter_table access modes)."""
    table: str
    mode: str            # read_only | insert_only | read_write


@dataclasses.dataclass
class NoOp:
    """A statement accepted for compatibility with no engine effect
    (unenforced ALTER access modes / post-hoc constraints)."""
    reason: str = ""


@dataclasses.dataclass
class Analyze:
    """ANALYZE sys [tbl [(cols)]] — statistics refresh (sql/scripts/
    80_statistics.sql; here stats derive on materialization, so this
    revalidates and bumps the cache epoch)."""
    table: Optional[str] = None


@dataclasses.dataclass
class SetVar:
    """SET var = expr (sql_parser.y set_statement; session variables,
    sql_mvc.c mvc vars)."""
    name: str
    value: Expr


@dataclasses.dataclass
class DeclareVar:
    """DECLARE v type (rel_psm.c declare; session-scoped here)."""
    name: str
    vtype: Any


@dataclasses.dataclass
class CreateUser:
    """CREATE USER u WITH PASSWORD 'p' (sql_user.c)."""
    name: str
    password: str


@dataclasses.dataclass
class DropUser:
    name: str


@dataclasses.dataclass
class CreateRole:
    name: str


@dataclasses.dataclass
class DropRole:
    name: str


@dataclasses.dataclass
class Grant:
    """GRANT privs ON t TO grantee | GRANT role TO user
    (sql_privileges.c sql_grant_table_privs / sql_grant_role)."""
    privs: Optional[List[str]]    # None for role grants
    table: str                    # table, or role name when role=True
    grantee: str
    role: bool = False


@dataclasses.dataclass
class Revoke:
    privs: Optional[List[str]]
    table: str
    grantee: str
    role: bool = False
