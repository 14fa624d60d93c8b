"""Access control through both packages (after tests/test_access.py):
users, roles, GRANT/REVOKE, row policies, quotas, SHOW GRANTS/USERS/ROLES
and the access system tables; each statement's TSV or error text and
error type compared, as the current user switches."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


def _run(script):
    """(user, sql) steps through a fresh pair of sessions; per package the
    TSV or 'ErrorType: text' of each step."""
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("t", {"id": np.arange(10, dtype=np.int64),
                             "region": ["eu", "us"] * 5})
        s.create_table("u2", {"id": np.arange(5, dtype=np.int64),
                              "x": np.arange(5, dtype=np.int64)})
        res = []
        for user, sql in script:
            s.current_user = user
            try:
                res.append(s.sql_tsv(sql))
            except Exception as e:          # noqa: BLE001
                res.append(f"{type(e).__name__}: {e}")
        out.append(res)
    return out


D = "default"
SCRIPTS = {
    "users_and_grants": [
        (D, "CREATE USER bob IDENTIFIED BY 'secret'"),
        ("bob", "SELECT * FROM t"),
        (D, "GRANT SELECT ON t TO bob"),
        ("bob", "SELECT count() FROM t"),
        ("bob", "INSERT INTO t VALUES (99, 'eu')"),
        ("bob", "DROP TABLE t"),
        ("bob", "GRANT ALL ON *.* TO bob"),
        ("bob", "SELECT t.id FROM t INNER JOIN u2 ON t.id = u2.id"),
        (D, "CREATE USER IF NOT EXISTS bob"),
        (D, "CREATE USER bob")],
    "revoke": [
        (D, "CREATE USER bob"),
        (D, "GRANT SELECT, INSERT ON t TO bob"),
        (D, "REVOKE INSERT ON t FROM bob"),
        ("bob", "SELECT count() FROM t"),
        ("bob", "INSERT INTO t VALUES (99, 'eu')")],
    "roles": [
        (D, "CREATE ROLE analyst"),
        (D, "GRANT SELECT ON * TO analyst"),
        (D, "CREATE USER alice"),
        (D, "GRANT analyst TO alice"),
        ("alice", "SELECT count() FROM t"),
        (D, "REVOKE analyst FROM alice"),
        ("alice", "SELECT * FROM t"),
        (D, "DROP ROLE analyst"),
        (D, "SHOW ROLES")],
    "row_policies": [
        (D, "CREATE USER eu_user"),
        (D, "GRANT SELECT ON t TO eu_user"),
        (D, "CREATE ROW POLICY eu_only ON t USING region = 'eu' TO eu_user"),
        ("eu_user", "SELECT id, region FROM t ORDER BY id"),
        (D, "SELECT count() FROM t"),
        (D, "CREATE ROW POLICY all_rows ON t USING 1 TO ALL"),
        (D, "SELECT count() FROM t"),
        (D, "CREATE USER u"),
        (D, "GRANT SELECT ON t TO u"),
        (D, "CREATE ROW POLICY p1 ON t FOR SELECT USING id < 2 TO u"),
        (D, "CREATE ROW POLICY p2 ON t USING id >= 8 TO u"),
        ("u", "SELECT id FROM t ORDER BY id"),
        (D, "SELECT name, table, select_filter, apply_to FROM "
            "system.row_policies ORDER BY name"),
        (D, "SHOW ROW POLICIES"),
        (D, "DROP ROW POLICY all_rows ON t"),
        (D, "DROP ROW POLICY eu_only ON t"),
        (D, "DROP ROW POLICY p1 ON t"),
        (D, "DROP ROW POLICY p2 ON t"),
        (D, "SELECT count() FROM t")],
    "quotas": [
        (D, "CREATE USER q"),
        (D, "GRANT SELECT ON t TO q"),
        (D, "CREATE QUOTA q3 FOR INTERVAL 1 HOUR MAX queries = 3 TO q"),
        ("q", "SELECT count() FROM t"),
        ("q", "SELECT count() FROM t"),
        ("q", "SELECT count() FROM t"),
        ("q", "SELECT count() FROM t"),
        (D, "SELECT count() FROM t"),
        (D, "CREATE USER r"),
        (D, "GRANT SELECT ON t TO r"),
        (D, "CREATE QUOTA rq FOR INTERVAL 1 HOUR MAX result_rows = 10 TO r"),
        ("r", "SELECT * FROM t"),
        ("r", "SELECT * FROM t"),
        (D, "SELECT name, interval_seconds, limits, apply_to FROM "
            "system.quotas ORDER BY name"),
        (D, "SHOW QUOTAS"),
        (D, "DROP QUOTA rq"),
        (D, "SHOW QUOTAS")],
    "show_and_system_tables": [
        (D, "CREATE USER bob IDENTIFIED BY 'x'"),
        (D, "CREATE ROLE analyst"),
        (D, "GRANT SELECT ON t TO bob"),
        (D, "GRANT SELECT, INSERT ON u2 TO analyst"),
        (D, "SHOW GRANTS FOR bob"),
        (D, "SHOW GRANTS"),
        (D, "SHOW USERS"),
        (D, "SHOW ROLES"),
        (D, "SELECT name, auth_type, default_roles FROM system.users "
            "ORDER BY name"),
        (D, "SELECT grantee, grantee_type, access_type, table FROM "
            "system.grants WHERE grantee != 'default' ORDER BY grantee, "
            "access_type")],
    "drop_principals": [
        (D, "CREATE USER tmp"),
        (D, "DROP USER tmp"),
        (D, "DROP USER tmp"),
        (D, "DROP USER IF EXISTS tmp"),
        (D, "DROP USER default"),
        (D, "DROP ROLE IF EXISTS nope"),
        (D, "DROP QUOTA nope")],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_access_matches_the_jax_package(name):
    j, p = _run(SCRIPTS[name])
    assert p == j


def test_authentication_and_error_types():
    from myscaledb_tpu_torch.runtime.access import (AccessDeniedError,
                                                     QuotaExceededError)
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.create_table("t", {"id": np.arange(3, dtype=np.int64)})
    s.sql("CREATE USER bob IDENTIFIED BY 'pw1'")
    assert s.access.authenticate("bob", "pw1") == "bob"
    with pytest.raises(AccessDeniedError):
        s.access.authenticate("bob", "wrong")
    s.sql("CREATE QUOTA one FOR INTERVAL 1 HOUR MAX queries = 1 TO bob")
    s.sql("GRANT SELECT ON t TO bob")
    s.current_user = "bob"
    s.sql("SELECT count() FROM t")
    with pytest.raises(QuotaExceededError):
        s.sql("SELECT count() FROM t")
    s.current_user = "default"
    s.settings.readonly = True
    assert s.sql("SHOW USERS").to_rows() == [("bob",), ("default",)]
    with pytest.raises(PermissionError, match="readonly"):
        s.sql("CREATE USER eve")
