"""One execution lock per session, for every protocol: two users under
complementary row policies query one session at the same time over HTTP,
MySQL and PostgreSQL (six client threads, 200 rounds each), and every
answer is exactly that user's count.  The JAX package's MySQL and
PostgreSQL servers swap ``session.current_user`` around ``session.sql``
with no lock, and its HTTP and gRPC servers hold locks of their own, so
there one connection's statement can run as another connection's user
(ROADMAP section 3); the port runs every statement through
``Session.sql_as`` under ``Session.exec_lock``."""

import sys
import threading
import urllib.request

import numpy as np

from myscaledb_tpu_torch import connect
from myscaledb_tpu_torch.runtime.mysql_server import serve_mysql
from myscaledb_tpu_torch.runtime.pg_server import serve_pg
from myscaledb_tpu_torch.runtime.server import make_server
from tools.wire_clients import MySQLClient, PGClient

ROUNDS = 200
SQL = "SELECT count() FROM hits"


def _session():
    rng = np.random.default_rng(3)
    n = 20_000
    counter = np.where(rng.random(n) < 0.3, 62,
                       rng.integers(1, 7000, n)).astype(np.int32)
    s = connect(device="cpu")
    s.create_table("hits", {"CounterID": counter,
                            "UserID": rng.integers(0, 1 << 40, n)})
    for user, cond in (("u62", "CounterID = 62"),
                       ("urest", "CounterID != 62")):
        s.sql(f"CREATE USER {user}")
        s.sql(f"GRANT SELECT ON hits TO {user}")
        s.sql(f"CREATE ROW POLICY p_{user} ON hits USING {cond} TO {user}")
    want = {"u62": int((counter == 62).sum()),
            "urest": int((counter != 62).sum())}
    return s, want


def test_concurrent_users_get_their_own_rows():
    s, want = _session()
    http = make_server(s, "127.0.0.1", 0)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    mysql = serve_mysql(s, "127.0.0.1", 0)
    pg = serve_pg(s, "127.0.0.1", 0)
    servers = (http, mysql, pg)
    errors, counts = [], {}

    def http_client(user):
        host, port = http.server_address
        for _ in range(ROUNDS):
            req = urllib.request.Request(
                f"http://{host}:{port}/", data=SQL.encode(),
                headers={"X-ClickHouse-User": user})
            with urllib.request.urlopen(req, timeout=10) as r:
                yield int(r.read())

    def mysql_client(user):
        c = MySQLClient(*mysql.server_address, user=user)
        try:
            for _ in range(ROUNDS):
                yield int(c.query(SQL)[1][0][0])
        finally:
            c.close()

    def pg_client(user):
        c = PGClient(*pg.server_address, user=user)
        try:
            for _ in range(ROUNDS):
                yield int(c.query(SQL)[1][0][0])
        finally:
            c.close()

    def run(proto, client, user):
        try:
            got = list(client(user))
            counts[(proto, user)] = got
        except Exception as e:                            # noqa: BLE001
            errors.append(f"{proto} {user}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(proto, client, user))
               for proto, client in (("http", http_client),
                                     ("mysql", mysql_client),
                                     ("pg", pg_client))
               for user in want]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert errors == []
    assert len(counts) == 6
    for (proto, user), got in counts.items():
        wrong = [c for c in got if c != want[user]]
        assert len(got) == ROUNDS and wrong == [], (proto, user, wrong[:5])
    assert s.current_user == "default"
